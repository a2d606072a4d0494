"""Binary model save and load of the port (h2o3_tpu/genmodel/mojo.py
`save_model`/`load_model`; water/api/ModelsHandler exportBinaryModel).

`save_model` pickles the whole model, as the JAX package does, with what
lives on a device reduced to host form, so a model saved on the card
loads on a machine without one:
  * a tensor (and an nn.Parameter) as its bytes, dtype and shape;
  * a torch.device as the load's device;
  * a torch.Generator as its device type and state;
  * a Frame as its `.hex` bytes (io/persist.py), its key kept.
`load_model(path, device=None)` puts every tensor, Frame and generator on
`device`, by default the cloud's (the card unless `init(device="cpu")`);
a generator saved on another device type restarts from its initial seed.
A model with a key (every estimator but the target encoder, which has
none) is put in the store under it.

`export_mojo` and `MojoModel` (the scoring artifact) wait for the
front ends (ROADMAP.md §1 item 10).
"""

from __future__ import annotations

import io
import pickle
import threading

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV

_TARGET = threading.local()


def _target():
    dev = getattr(_TARGET, "device", None)
    if dev is None:
        from h2o3_tpu_torch.parallel.mesh import cloud
        dev = cloud().device
    return dev


def _restore_tensor(raw: np.ndarray, dtype: str, shape: tuple,
                    parameter: bool, requires_grad: bool):
    t = torch.from_numpy(raw.copy()).view(getattr(torch, dtype))
    t = t.reshape(shape).to(_target())
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _restore_generator(kind: str, state: np.ndarray, seed: int):
    dev = _target()
    g = torch.Generator(device=dev)
    if dev.type == kind:
        g.set_state(torch.from_numpy(state.copy()))
    else:
        g.manual_seed(seed)
    return g


def _restore_frame(hex_bytes: bytes, key: str):
    from h2o3_tpu_torch.io.persist import _read_hex
    return _read_hex(io.BytesIO(hex_bytes), key, device=_target())


class _ModelPickler(pickle.Pickler):
    """Device state reduced to host form (the JAX package's
    `_ModelPickler` does this for jax.Array)."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy().copy()
            return _restore_tensor, (
                raw, str(t.dtype).split(".")[1], tuple(t.shape),
                isinstance(obj, torch.nn.Parameter), obj.requires_grad)
        if isinstance(obj, torch.device):
            # a model keeps the device it trained on to make its tensors
            # there: it becomes the load's device
            return _target, ()
        if isinstance(obj, torch.Generator):
            return _restore_generator, (obj.device.type,
                                        obj.get_state().numpy().copy(),
                                        obj.initial_seed())
        if isinstance(obj, Frame):
            from h2o3_tpu_torch.io.persist import _write_hex
            buf = io.BytesIO()
            _write_hex(obj, buf)
            return _restore_frame, (buf.getvalue(), obj.key)
        return NotImplemented


def save_model(model, path: str) -> str:
    """h2o.save_model: the model as one binary file at `path`."""
    with open(path, "wb") as f:
        _ModelPickler(f, protocol=5).dump(model)
    return path


def load_model(path: str, device=None):
    """h2o.load_model: a saved model, its tensors on `device` (by default
    the cloud's), put in the store."""
    _TARGET.device = torch.device(device) if device is not None else None
    try:
        with open(path, "rb") as f:
            m = pickle.load(f)
    finally:
        _TARGET.device = None
    if getattr(m, "key", None):
        DKV.put(m.key, m)
    return m
