from scenelib2_torch.io.pgm import read_pgm, write_pgm
from scenelib2_torch.io.sequence import ImageSequence

__all__ = ["read_pgm", "write_pgm", "ImageSequence"]
