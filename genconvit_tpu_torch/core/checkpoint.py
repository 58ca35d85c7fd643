"""Checkpoint I/O (port of genconvit_tpu/core/checkpoint.py:21-123) without
flax or msgpack.

A `.gcv` file is one msgpack object, the payload {"format", "epoch",
"min_loss", "params", "opt_state", "extra"} as flax 0.12's
`serialization.msgpack_serialize` writes it. This module reads and writes
the subset of msgpack that flax produces:

  nil, bool, int (fixint, uint/int 8-64), float 32/64, str, bin 8/16/32,
  fixarray/array16/32, fixmap/map16/32, fixext and ext 8/16/32;
  ext 1: an ndarray, itself a msgpack (shape, dtype name, C-order bytes);
  ext 2: a complex number (real, imag); ext 3: a numpy scalar (as ext 1);
  {"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}:
  an array above flax's MAX_CHUNK_SIZE (2^30 bytes) split in flat chunks,
  which every real VAE checkpoint has (its f32 latent heads are 1.26 GB).

A training checkpoint's "opt_state" is the optimizer state in the layout
`flax.serialization.to_state_dict(tx.init(params))` gives for the JAX
package's optimizer (`opt_state_tree`, `restore_opt_state`).

Arrays are views of the file's buffer (`np.frombuffer`, no copy each), so
reading takes about the file's size once more for the chunked arrays'
joins. bfloat16 arrays (numpy has no such dtype) come back as
torch.bfloat16 tensors through a uint16 view; every other array is numpy.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from genconvit_tpu_torch.core.convert import (branch_spec, state_dict_from_jax,
                                              state_dict_from_reference, tree_from_state_dict)

FORMAT = "genconvit_tpu.ckpt.v1"
MAX_CHUNK_SIZE = 2**30   # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ reading


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str) -> Any:
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def obj(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        if b in (0xC4, 0xC5, 0xC6):               # bin 8/16/32: a view, no copy
            return self._take(self._unpack((">B", ">H", ">I")[b - 0xC4]))
        if b in (0xD9, 0xDA, 0xDB):               # str 8/16/32
            return str(self._take(self._unpack((">B", ">H", ">I")[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):                     # array 16/32
            return [self.obj() for _ in range(self._unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):                     # map 16/32
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:                     # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return _ext(code, self._take(1 << (b - 0xD4)))
        if b in (0xC7, 0xC8, 0xC9):               # ext 8/16/32
            n = self._unpack((">B", ">H", ">I")[b - 0xC7])
            code = self._unpack(">b")
            return _ext(code, self._take(n))
        raise ValueError(f"msgpack type byte {b:#x} is outside the subset flax writes")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _unpack_all(data: memoryview) -> Any:
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} trailing bytes after the msgpack object")
    return out


def _array(payload: memoryview):
    shape, name, raw = _unpack_all(payload)
    name = name if isinstance(name, str) else str(name, "utf-8")
    if name == "bfloat16":
        flat = np.frombuffer(raw, dtype=np.uint16)
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(tuple(shape))


def _ext(code: int, payload: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _array(payload)
    if code == _EXT_NPSCALAR:
        return _array(payload)[()]
    if code == _EXT_COMPLEX:
        re_, im = _unpack_all(payload)
        return complex(re_, im)
    raise ValueError(f"msgpack ext code {code} is not one flax writes")


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk_tree(v) for v in tree]
    return tree


def msgpack_restore(data) -> Any:
    """flax.serialization.msgpack_restore: bytes-like -> tree (array leaves
    are views of `data`, which they keep alive)."""
    return _unchunk_tree(_unpack_all(memoryview(data)))


def _read_file(path: str) -> bytearray:
    """The file in one writable buffer (arrays viewing it are writable)."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise IOError(f"short read: {path}")
    return buf


def load_checkpoint(path: str) -> Dict[str, Any]:
    payload = msgpack_restore(_read_file(path))
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"not a genconvit_tpu checkpoint: {path}")
    return payload


# ------------------------------------------------------------------ writing


def _uint(n: int, small: Tuple[int, int], codes: Tuple[int, int, int]) -> bytes:
    """A length header: fixed form below small[1] (small[0] | n), else the
    8/16/32-bit form (codes), as msgpack-python's packer picks them."""
    base, limit = small
    if base is not None and n < limit:
        return bytes([base | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} out of msgpack range")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _uint(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b


def _array_parts(a) -> Tuple[List[Any], int]:
    """The ext-1 payload of an array, (shape, dtype name, bytes) packed, as
    parts (the data itself is not copied) and its length."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            name, data, shape = "bfloat16", a.view(torch.uint16).numpy(), tuple(a.shape)
        else:
            data = a.numpy()
            name, shape = data.dtype.name, data.shape
    else:
        data = np.require(a, requirements="C")      # keeps 0-d arrays 0-d
        name, shape = data.dtype.name, data.shape
    head = _uint(3, (0x90, 16), (None, 0xDC, 0xDD))
    head += _uint(len(shape), (0x90, 16), (None, 0xDC, 0xDD)) + b"".join(_int(d) for d in shape)
    head += _str(name) + _uint(data.nbytes, (None, 0), (0xC4, 0xC5, 0xC6))
    body = memoryview(data.reshape(-1).view(np.uint8))
    return [head, body], len(head) + data.nbytes


def _ext_parts(code: int, parts: List[Any], n: int) -> List[Any]:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fix[n]]) if n in fix
            else _uint(n, (None, 0), (0xC7, 0xC8, 0xC9)))
    return [head + struct.pack(">b", code)] + parts


def _nbytes(v) -> int:
    return v.element_size() * v.nelement() if isinstance(v, torch.Tensor) else v.nbytes


def _chunked(a) -> Dict[str, Any]:
    """flax.serialization._chunk: the flat array in pieces of MAX_CHUNK_SIZE
    bytes, shape and chunks as {"0": ...} dicts."""
    item = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // item)
    flat = a.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[i: i + size] for j, i in enumerate(range(0, n, size))}}


def _pack(obj: Any, out: List[Any], sort: bool = True) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        out.append(_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(_uint(len(obj), (None, 0), (0xC4, 0xC5, 0xC6)))
        out.append(bytes(obj))
    elif isinstance(obj, dict):
        out.append(_uint(len(obj), (0x80, 16), (None, 0xDE, 0xDF)))
        # flax's tree_map copy sorts the keys; its chunk dicts are made after
        # it, in insertion order
        sort = sort and CHUNKED not in obj
        for k, v in (sorted(obj.items()) if sort else obj.items()):
            _pack(k, out)
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunked(v)
            _pack(v, out, sort)
    elif isinstance(obj, (list, tuple)):
        out.append(_uint(len(obj), (0x90, 16), (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        out.extend(_ext_parts(_EXT_NDARRAY, *_array_parts(obj)))
    elif isinstance(obj, np.generic):
        out.extend(_ext_parts(_EXT_NPSCALAR, *_array_parts(np.asarray(obj))))
    elif isinstance(obj, complex):
        payload = b"\x92" + b"\xcb" + struct.pack(">d", obj.real) + b"\xcb" + struct.pack(">d", obj.imag)
        out.extend(_ext_parts(_EXT_COMPLEX, [payload], len(payload)))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def save_checkpoint(path: str, params: Any, *, epoch: int = 0, min_loss: float = 0.0,
                    opt_state: Any = None, extra: Optional[Dict[str, Any]] = None) -> None:
    """The JAX package's payload (`:27-46` there) for a tree of dicts and
    lists whose leaves are numpy arrays or torch tensors; flax's
    `msgpack_restore` reads the file back."""
    payload = {"format": FORMAT, "epoch": int(epoch), "min_loss": float(min_loss),
               "params": params, "opt_state": opt_state, "extra": extra or {}}
    parts: List[Any] = []
    _pack(payload, parts)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for p in parts:
            f.write(p)
    os.replace(tmp, path)


# ------------------------------------------------------------------ params


def load_params(path: str, which: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """A branch's reference-keyed state dict and the file's meta, from a
    native checkpoint (`.gcv`/`.msgpack`: the JAX tree, unwrapped where
    train_model nested it under 'ed'/'vae', then `state_dict_from_jax`) or
    a reference torch file (`.pth`/`.pt`: `state_dict_from_reference`).
    The meta holds `branch_spec`'s head_act (and the VAE's variant): the
    module the state dict loads into."""
    if path.endswith((".pth", ".pt")):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = state_dict_from_reference(obj, which)
        return sd, {"source": "torch", "path": path, **branch_spec(sd, which)}
    payload = load_checkpoint(path)
    params = payload["params"]
    if isinstance(params, dict) and which in params and set(params) <= {"ed", "vae"}:
        params = params[which]
    sd = state_dict_from_jax(params, which)
    return sd, {"source": "native", "path": path, "epoch": payload.get("epoch"),
                "min_loss": payload.get("min_loss"), **branch_spec(sd, which)}


def resolve_weight(weight_dir: str, name: str) -> Optional[str]:
    """A weight file by basename, native extensions before torch ones (the
    reference resolves 'weight/{name}.pth', model/genconvit.py:16)."""
    for ext in ("", ".gcv", ".msgpack", ".pth", ".pt"):
        p = os.path.join(weight_dir, name + ext)
        if os.path.isfile(p):
            return p
    return None


# ------------------------------------------------------------------ optimizer state


def _state_dict_form(tree: Any) -> Any:
    """flax.serialization.to_state_dict of a tree of dicts and lists: each
    list becomes a dict keyed "0", "1", ..."""
    if isinstance(tree, dict):
        return {k: _state_dict_form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict_form(v) for i, v in enumerate(tree)}
    return tree


def _list_form(tree: Any) -> Any:
    """The inverse of _state_dict_form for a parameter tree (none of whose
    dicts is keyed by indices)."""
    if isinstance(tree, dict):
        if tree and set(tree) == {str(i) for i in range(len(tree))}:
            return [_list_form(tree[str(i)]) for i in range(len(tree))]
        return {k: _list_form(v) for k, v in tree.items()}
    return tree


def opt_state_tree(optimizer: torch.optim.Optimizer,
                   branches: Mapping[str, torch.nn.Module]) -> Dict[str, Any]:
    """The torch Adam's state (`train/optim.make_optimizer`) in the layout of
    the JAX package's optax state (inject_hyperparams over chain(masked
    decay, scale_by_adam, scale)) as to_state_dict flattens it: top-level
    count and hyperparams.lr, the masked decay's empty state ("0"), Adam's
    count, mu and nu ("1") as trees of each branch's parameters (the
    BatchNorm running statistics' moments, which optax keeps and which stay
    zero, as zeros), the scale's empty state ("2"). A branch split over a
    mesh's 'model' axis (its `tp`) has its moments gathered into the
    one-device layout (every rank of the model group must call it)."""
    from genconvit_tpu_torch.parallel.mesh import all_gather_state_dict

    count = 0
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    for name, module in branches.items():
        params = dict(module.named_parameters())
        mu_sd, nu_sd = {}, {}
        for key, v in module.state_dict().items():
            st = optimizer.state.get(params[key], {}) if key in params else {}
            if "step" in st:
                count = int(st["step"])
            mu_sd[key] = st.get("exp_avg", torch.zeros_like(v))
            nu_sd[key] = st.get("exp_avg_sq", torch.zeros_like(v))
        tp = getattr(module, "tp", None)
        if tp is not None:
            mu_sd, nu_sd = all_gather_state_dict(mu_sd, tp), all_gather_state_dict(nu_sd, tp)
        mu[name] = tree_from_state_dict(mu_sd, name)
        nu[name] = tree_from_state_dict(nu_sd, name)
    lr = optimizer.param_groups[0]["lr"]
    cnt = np.asarray(count, np.int32)
    return {"count": cnt, "hyperparams": {"lr": np.asarray(lr, np.float32)},
            "hyperparams_states": {},
            "inner_state": {"0": {"inner_state": {}},
                            "1": {"count": cnt.copy(), "mu": _state_dict_form(mu),
                                  "nu": _state_dict_form(nu)},
                            "2": {}}}


def restore_opt_state(optimizer: torch.optim.Optimizer, branches: Mapping[str, torch.nn.Module],
                      saved: Mapping[str, Any]) -> None:
    """Load an optimizer state of `opt_state_tree`'s layout, written by
    either package, into the torch Adam over `branches`' parameters: the
    learning rate, and Adam's count and moments per parameter (this rank's
    blocks of them for a branch split over a mesh's 'model' axis)."""
    from genconvit_tpu_torch.parallel.mesh import split_state_dict

    lr = float(np.asarray(saved["hyperparams"]["lr"]))
    adam = saved["inner_state"]["1"]
    count = int(np.asarray(adam["count"]))
    for group in optimizer.param_groups:
        group["lr"] = lr
    for name, module in branches.items():
        mu = state_dict_from_jax(_list_form(adam["mu"][name]), name)
        nu = state_dict_from_jax(_list_form(adam["nu"][name]), name)
        tp = getattr(module, "tp", None)
        if tp is not None:
            mu, nu = (split_state_dict(m, tp.index, tp.size) for m in (mu, nu))
        for key, p in module.named_parameters():
            if count == 0:
                optimizer.state.pop(p, None)
                continue
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[key].to(p.device, p.dtype).contiguous(),
                "exp_avg_sq": nu[key].to(p.device, p.dtype).contiguous()}
