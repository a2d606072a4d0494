"""Chunk spill files: the disk tier of the port's chunk pager
(h2o3_tpu/io/spill.py, water/persist/PersistIce.java).

One file holds one chunk's packed planes (the codec plane and its
optional uint8 NA plane) exactly as the codec produced them, through
`np.savez`: each plane comes back bit for bit in its own dtype (int8,
int16, int32, float32 or uint8), so a disk-to-host promotion decodes
nothing. The pager owns each file's lifetime: it deletes the file when
the chunk leaves the disk tier or is garbage-collected.

Files live under the ice root (`H2O3_TPU_ICE_ROOT`, by default
`~/.h2o3_tpu_ice`), in a subdirectory of each process: chunk keys are a
counter of the process, so two processes sharing one root would
otherwise overwrite each other's files. The params files are the disk
rung of model parameters, kept so that the module is whole.
"""

from __future__ import annotations

import os
import re

import numpy as np

from h2o3_tpu_torch.utils.env import env_str

_DEFAULT_ICE = os.path.join(os.path.expanduser("~"), ".h2o3_tpu_ice")
_ICE_ROOT = env_str("H2O3_TPU_ICE_ROOT", "") or _DEFAULT_ICE

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
_PROC_TAG = f"p{os.getpid()}"


def get_ice_root() -> str:
    return _ICE_ROOT


def set_ice_root(path: str):
    """Point the spill tier elsewhere (the memory manager's `ice_root`
    delegates here)."""
    global _ICE_ROOT
    _ICE_ROOT = str(path)


def chunk_dir() -> str:
    return os.path.join(_ICE_ROOT, "chunks", _PROC_TAG)


def _write_npz(path: str, arrays: dict) -> str:
    """Write to a temporary name and rename, so a reader never sees a
    torn file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def write_chunk(key: str, data: np.ndarray, mask) -> str:
    """Write one chunk's packed planes, uncompressed (they are packed
    already, and spill bandwidth bounds demotion); returns the path."""
    d = chunk_dir()
    os.makedirs(d, exist_ok=True)
    arrays = {"data": np.asarray(data)}
    if mask is not None:
        arrays["mask"] = np.asarray(mask)
    return _write_npz(os.path.join(d, f"{_SAFE.sub('_', key)}.npz"), arrays)


def read_chunk(path: str):
    """(data, mask or None): the packed planes of a spill file."""
    with np.load(path, allow_pickle=False) as npz:
        data = npz["data"]
        mask = npz["mask"] if "mask" in npz.files else None
    return data, mask


def delete_chunk(path: str):
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def params_dir() -> str:
    return os.path.join(_ICE_ROOT, "params", _PROC_TAG)


def write_params(key: str, leaves) -> str:
    """A model's parameter arrays, in order, as one npz; returns the
    path."""
    d = params_dir()
    os.makedirs(d, exist_ok=True)
    arrays = {f"l{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    return _write_npz(os.path.join(d, f"{_SAFE.sub('_', key)}.npz"), arrays)


def read_params(path: str) -> list:
    """The arrays back, in the order write_params received them."""
    with np.load(path, allow_pickle=False) as npz:
        return [npz[f"l{i}"] for i in range(len(npz.files))]


def delete_params(path: str):
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
