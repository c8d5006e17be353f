from scenelib2_torch.io.pgm import read_pgm, write_pgm

__all__ = ["read_pgm", "write_pgm"]
