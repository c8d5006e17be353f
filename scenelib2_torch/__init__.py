"""scenelib2_torch — PyTorch/CUDA port of the scenelib2_tpu MonoSLAM pipeline.

A second package beside the JAX one: the same state layout, the same
per-frame decisions, with every TPU kernel on its path replaced by a kernel
written by hand for an NVIDIA Hopper GPU (kernels/csrc/*.cu, built with nvcc
on first use). Each kernel module also holds a plain PyTorch version of the
same function, which is what runs for CPU tensors.

Entry points run on CUDA unless the caller passes device="cpu". The state
is f32, the fast mode of the JAX package (SCENELIB2_X64=0).

Ported so far: the whole single-stream f32 step, stages 1-8 of go_one_step
(EKF predict, measurement prediction and selection, NSSD search, joint
update, bookkeeping, auto-initialisation, the partial-feature particle
stage), with mapping on or off, at every map size the JAX fast step runs
(max_features up to 128, routed by state size as JAX routes it); batch
mode (parallel.mesh); CUDA-graph replay of go_one_step (one graph replay a
frame) and run_sequence; the rest of the MonoSLAM facade (manual inits,
feature bookkeeping, checkpoints in the JAX package's layout); the entry
points: io.ImageSequence with the native frame grabber, io.camera, the
selftest, the bench suite and the CLI (python -m scenelib2_torch.cli); the
pure-XLA route (use_pallas=False) and the f64 parity mode
(precision="f64": with use_pallas=False the parity route, no kernel; with
use_pallas=True JAX's hybrid route) with eval.metrics.run_parity_eval.

    slam = MonoSLAM("data/SceneLib2.cfg")
    for frame in ImageSequence(seq_dir):
        slam.go_one_step(frame)
"""

import torch as _torch

# f32 products must stay f32: TF32 keeps ~3 decimal digits, and the JAX
# package records that reduced-precision matmuls broke feature matching
# (scenelib2_tpu/__init__.py:28-31)
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from scenelib2_torch.config import Params, SlamConfig, load_config, parse_cfg_file  # noqa: E402
from scenelib2_torch.io.sequence import ImageSequence  # noqa: E402
from scenelib2_torch.runtime.slam import MonoSLAM  # noqa: E402

__all__ = ["Params", "SlamConfig", "load_config", "parse_cfg_file", "MonoSLAM", "ImageSequence"]

__version__ = "0.1.0"
