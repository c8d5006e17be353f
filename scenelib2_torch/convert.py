"""Carry a SlamState between the JAX package and the port.

The two packages share the state layout exactly (slot i at 13 + 6i, labels
int32, patches uint8, drand48 state as three 16-bit limbs), so a state moves
field by field through numpy. This is the port's "weights" path: the same
state goes into both packages, and a JAX checkpoint (the
``state_<field>`` keys that scenelib2_tpu's MonoSLAM.save_checkpoint writes)
loads into the port.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from scenelib2_torch.runtime.state import SlamState, patch_row

_FLOAT = ("x", "P", "xp_org", "lam", "prob")
_BOOL = ("active", "full", "palive", "sched")
_INT32 = ("label", "attempts", "successes", "match_attempts", "next_label", "frame_no", "rng")


def state_from_jax(arrays: Mapping[str, np.ndarray], device, dtype=torch.float32) -> SlamState:
    """JAX SlamState fields (numpy arrays, by field name or by the
    ``state_<field>`` checkpoint key) -> the port's SlamState on `device`,
    its filter floats in `dtype`. A checkpoint without ``sched`` or
    ``patch_rows`` (older writers) gets them as the JAX loader does: all
    False, and derived from the patches. Stacked JAX states (a leading lane
    dimension on every array, as jax.vmap carries them) convert the same
    way into a state with lanes."""
    def get(name):
        if name in arrays:
            return np.asarray(arrays[name])
        key = f"state_{name}"
        if key in arrays:
            return np.asarray(arrays[key])
        return None

    fields = {}
    for name in SlamState._fields:
        a = get(name)
        if a is None:
            if name == "sched":
                a = np.zeros(get("active").shape, bool)
            elif name != "patch_rows":
                raise KeyError(f"JAX state is missing field {name!r}")
        fields[name] = a
    out = {}
    for name, a in fields.items():
        if name == "patch_rows":
            continue
        if name in _FLOAT:
            t = torch.as_tensor(a.astype(np.float64 if dtype == torch.float64 else np.float32))
        elif name in _BOOL:
            t = torch.as_tensor(a.astype(bool))
        elif name in _INT32:
            t = torch.as_tensor(a.astype(np.int32))
        elif name == "patches":
            t = torch.as_tensor(a.astype(np.uint8))
        else:
            raise KeyError(name)
        out[name] = t.to(device)
    if fields["patch_rows"] is None:
        out["patch_rows"] = patch_row(out["patches"])
    else:
        out["patch_rows"] = torch.as_tensor(fields["patch_rows"].astype(np.float32)).to(device)
    return SlamState(**out)


def state_to_numpy(state: SlamState) -> dict[str, np.ndarray]:
    """The port's SlamState -> numpy arrays with the JAX package's dtypes
    (rng as uint32 limbs)."""
    out = {}
    for name, t in state._asdict().items():
        a = t.detach().cpu().numpy()
        if name == "rng":
            a = a.astype(np.uint32)
        out[name] = a
    return out
