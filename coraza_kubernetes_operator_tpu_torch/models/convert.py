"""Carry compiled device tables across as plain arrays.

For this system the "weights" are the compiled device tables of a
``WafModel``. ``model_from_arrays`` builds the port's model from plain
numpy arrays and Python statics — one entry per ``WafModel`` field, with
nested banks given as lists of dicts — so tables laid out elsewhere (for
example by the JAX package's ``build_model``, read out with
``np.asarray``) run here unchanged. ``model_to_arrays`` is its inverse.

bfloat16 fields (segment kernels, flat-bin selectors and the narrow flat
table segments) may arrive as float32 or as numpy bfloat16 arrays; they
are cast to the dtype ``build_model`` gives them, which is exact for the
small integers they hold.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.dfa import DFABank
from ..ops.dfa_flat import FlatBank
from ..ops.dfa_gather import GatherBank
from ..ops.segment import SegmentBlock, SegmentSpec
from ..utils.device import resolve_device
from .waf_model import WafModel

_BANK_LISTS = {
    "banks": DFABank,
    "long_banks": DFABank,
    "pre_banks": DFABank,
    "gather_banks": GatherBank,
    "flat_banks": FlatBank,
    "segs": SegmentBlock,
}
_FLAT_STATICS = ("seg_pipes", "seg_slots", "group_pipe", "pieces")


def _init_fields(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls) if f.init]


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy bfloat16 (ml_dtypes) has no torch twin
        a = a.astype(np.float32)
    t = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return t if dtype is None else t.to(dtype)


def _flat_table_dtypes(d: dict) -> list[torch.dtype]:
    """bf16 for a table segment whose groups all have 2*S <= 256, else
    float32 — ``build_flat_bank``'s rule, recovered from the slot layout."""
    g = len(np.asarray(d["always"]))
    base = np.asarray(d["base_g"], dtype=np.float64)[0, :g]
    sizes = np.asarray(d["s_g"], dtype=np.float64)[0, :g]
    out, off = [], 0
    for n in d["seg_slots"]:
        inside = (base >= off) & (base < off + n)
        out.append(torch.bfloat16 if np.all(2 * sizes[inside] <= 256) else torch.float32)
        off += n
    return out


def _bank_from(cls, d: dict, device):
    if cls is SegmentBlock:
        return SegmentBlock(
            kernel=_tensor(d["kernel"], device, torch.bfloat16),
            spec=SegmentSpec(**d["spec"]),
        )
    if cls is FlatBank:
        dts = _flat_table_dtypes(d)
        kw = {k: tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in d[k])
              for k in _FLAT_STATICS}
        return FlatBank(
            tables=tuple(_tensor(t, device, dt) for t, dt in zip(d["tables"], dts)),
            sel=_tensor(d["sel"], device, torch.bfloat16),
            bcast=_tensor(d["bcast"], device, torch.bfloat16),
            init_sigma=_tensor(d["init_sigma"], device),
            mend=_tensor(d["mend"], device),
            base_g=_tensor(d["base_g"], device),
            s_g=_tensor(d["s_g"], device),
            always=_tensor(d["always"], device),
            **kw,
        )
    return cls(**{k: _tensor(d[k], device) for k in _init_fields(cls)})


def model_from_arrays(arrays: dict, device=None) -> WafModel:
    """The port's ``WafModel`` from plain arrays and statics (see the
    module docstring). ``device`` defaults to the card."""
    device = resolve_device(device)
    kw = {}
    for name in _init_fields(WafModel):
        v = arrays[name]
        if name in _BANK_LISTS:
            kw[name] = [_bank_from(_BANK_LISTS[name], d, device) for d in v]
        elif name == "seg_perm":
            kw[name] = None if v is None else _tensor(v, device)
        elif isinstance(v, np.ndarray):
            kw[name] = _tensor(v, device)
        else:
            kw[name] = v
    return WafModel(**kw)


def _array(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def _bank_to(bank) -> dict:
    if isinstance(bank, SegmentBlock):
        return {"kernel": _array(bank.kernel), "spec": dataclasses.asdict(bank.spec)}
    out = {}
    for name in _init_fields(type(bank)):
        v = getattr(bank, name)
        if isinstance(v, torch.Tensor):
            out[name] = _array(v)
        elif name == "tables":
            out[name] = [_array(t) for t in v]
        else:
            out[name] = v
    return out


def model_to_arrays(model: WafModel) -> dict:
    """Inverse of ``model_from_arrays``: numpy arrays (bfloat16 fields as
    float32) and statics."""
    out = {}
    for name in _init_fields(WafModel):
        v = getattr(model, name)
        if name in _BANK_LISTS:
            out[name] = [_bank_to(b) for b in v]
        elif isinstance(v, torch.Tensor):
            out[name] = _array(v)
        else:
            out[name] = v
    return out
