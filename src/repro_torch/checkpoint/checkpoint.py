"""Tree checkpointing: an npz payload and a json manifest.

Ported from `repro.checkpoint.checkpoint`, with its layout:

    <dir>/step_<N>/manifest.json + arrays.npz

written into ``step_<N>.tmp`` and renamed, so a step directory is always
whole.  `arrays.npz` holds ``leaf_<i>`` in JAX leaf order
(`utils.trees.leaves`); the manifest lists each leaf's path, shape and
dtype, with the paths spelled as `jax.tree_util.tree_flatten_with_path`
spells them (``['layers']`` for a dict key, ``[0]`` for a list index,
``.server`` for a NamedTuple field; ``None`` is an empty subtree) and the
dtypes by numpy's names (``"bfloat16"``, ``"float32"``, ``"int32"``).
`restore_checkpoint` validates the paths and shapes against a template
before it reads a leaf.

bfloat16 is stored as its bits under the descriptor ``'<V2'`` (two opaque
bytes): exactly the ``.npy`` member the reference's `np.savez` writes for
an ml_dtypes bfloat16 array, header included.  It is read back from such
bits, or from ``uint16``, by a view, never by a numeric cast, so nothing
here needs ml_dtypes.  The port thus
restores every checkpoint the reference writes, bfloat16 included, and the
reference restores the port's float32 and integer checkpoints.  (The
reference cannot restore bfloat16 from its own files: its numeric cast from
``|V2`` raises.)
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import server_shard
from repro_torch.sharding.rules import gather, local_index
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import leaves, unflatten


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX leaf order, each path as JAX spells it.  A
    sharded subtree (`core.server_shard.ShardedTree`) is gathered
    whole; one spread over processes is refused, as the reference cannot
    save an array its process does not address."""
    if tree is None:
        return []
    if server_shard.is_sharded(tree):
        if tree.spread:
            raise ValueError(
                "a server spread over processes cannot be checkpointed: "
                "each process holds only its own shards (save from a "
                "one-process run)")
        return _flatten_with_paths(tree.gather(), prefix)
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for name in tree._fields
                for x in _flatten_with_paths(getattr(tree, name),
                                             prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree)
                for x in _flatten_with_paths(sub, prefix + (f"[{i}]",))]
    return [("/".join(prefix), tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` → ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _to_host(t) -> np.ndarray:
    """A leaf as a numpy array; bfloat16 as its bits (``uint16``)."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _npy_bytes(a: np.ndarray, bf16: bool) -> bytes:
    """The ``.npy`` file of `a`; bfloat16 bits under the descriptor that
    ml_dtypes gives numpy (``'<V2'``), as the reference writes them."""
    buf = io.BytesIO()
    if not bf16:
        np.lib.format.write_array(buf, a, allow_pickle=False)
        return buf.getvalue()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
    buf.write(np.ascontiguousarray(a).tobytes())
    return buf.getvalue()


def _savez(path: str, arrays, bf16) -> None:
    """`np.savez`'s archive (stored, zip64) of ``leaf_<i>.npy`` members."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (a, b) in enumerate(zip(arrays, bf16)):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                f.write(_npy_bytes(a, b))


def _contiguous(a: np.ndarray) -> np.ndarray:
    """`a` C-contiguous, a 0-d array kept 0-d (`np.ascontiguousarray`
    alone returns it 1-d)."""
    return np.ascontiguousarray(a).reshape(a.shape)


def _from_host(a: np.ndarray, saved_dtype: str, want: torch.dtype,
               device) -> torch.Tensor:
    """A stored array as a tensor of `want` on `device`.  bfloat16 bits
    (two opaque bytes, ``'<V2'`` or ``'|V2'``, or ``uint16`` where the
    manifest says bfloat16) are viewed, not cast."""
    if a.dtype.kind == "V" or (saved_dtype == "bfloat16"
                               and a.dtype.itemsize == 2):
        if a.dtype.itemsize != 2:
            raise ValueError(f"{a.dtype.itemsize}-byte opaque leaf: only "
                             f"bfloat16 bits are read")
        t = torch.from_numpy(_contiguous(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(_contiguous(a))
    return t.to(device=device, dtype=want)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Save `tree` under ``<ckpt_dir>/step_<step>/``, atomically (a
    ``.tmp`` directory renamed over any earlier one).  Returns the step's
    directory.  A tree placed over processes (DTensor leaves) is gathered
    once, every process taking part, and rank 0 alone writes the
    reference's file."""
    if any(isinstance(leaf, DTensor) for leaf in leaves(tree)):
        tree = gather(tree)
        final = os.path.join(ckpt_dir, f"step_{step}")
        if dist.get_rank() != 0:
            return final
    flat = _flatten_with_paths(tree)
    host = [_to_host(leaf) for _, leaf in flat]
    dtypes = [_dtype_name(torch.as_tensor(leaf).dtype) for _, leaf in flat]
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "leaves": [{"path": p, "shape": list(a.shape), "dtype": dt}
                   for (p, _), a, dt in zip(flat, host, dtypes)],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _savez(os.path.join(tmp, "arrays.npz"), host,
           [dt == "bfloat16" for dt in dtypes])
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest N with a ``step_<N>`` directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None, device=None):
    """Restore into the structure of `template` → (tree, step, extra).

    The saved paths must be the template's and each shape its leaf's, else
    `ValueError`; each leaf comes back in its template leaf's dtype, on the
    template leaf's device (a meta template's on `device`, the card unless
    the caller passes another).  `step` defaults to the latest.  A sharded
    template is refused: restore the unsharded state, then place it.  A
    template placed over processes (DTensor leaves) reads the file on
    every process and keeps each leaf's shard by the template's
    placements.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if _sharded_nodes(template):
        raise ValueError("restore into the unsharded state, then place it "
                         "(round_trainer.shard_round_state)")
    flat = _flatten_with_paths(template)
    t_paths = [p for p, _ in flat]
    entries = manifest["leaves"]
    saved_paths = [e["path"] for e in entries]
    if saved_paths != t_paths:
        missing = set(t_paths) - set(saved_paths)
        extra_p = set(saved_paths) - set(t_paths)
        raise ValueError(
            f"checkpoint structure mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra_p)[:5]}")
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as z:
        for i, (e, (_, t)) in enumerate(zip(entries, flat)):
            a = z[f"leaf_{i}"]
            if list(a.shape) != list(t.shape):
                raise ValueError(
                    f"{e['path']}: shape {a.shape} != template {t.shape}")
            if isinstance(t, DTensor):
                whole = _from_host(a, e["dtype"], t.dtype, "cpu")
                out.append(DTensor.from_local(
                    whole[local_index(whole.shape, t.placements,
                                        t.device_mesh)].to(t.device),
                    t.device_mesh, t.placements, run_check=False,
                    shape=t.shape, stride=t.stride()))
                continue
            dev = t.device if t.device.type != "meta" else resolve_device(
                device)
            out.append(_from_host(a, e["dtype"], t.dtype, dev))
    return unflatten(template, out), step, manifest["extra"]


def _sharded_nodes(tree):
    """The subtrees of `tree` that are placed on shards."""
    if server_shard.is_sharded(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _sharded_nodes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _sharded_nodes(sub)]
    return []
