"""Shape-string helpers shared by the roofline (``repro_torch.launch.analysis``)
and the recorder of one rank's program (the twin of ``repro.analysis.hlo``).

The reference parses the type strings of compiled HLO (``bf16[16,4096]``,
tuples of them).  The port has no compiled text: each op that its recorder
sees spells its result in the same syntax (``type_str``, from a torch dtype
through ``TORCH_DTYPE_NAMES``), so the two packages' per-op records can be
compared line by line, and ``shape_dims``/``shape_bytes`` read both.

The reference's third role here, detecting the buffer-donation attributes
in lowered text, has no counterpart: the port checks donation on the
buffers themselves, after the call (``repro_torch.analysis.trace.
verify_donation``).
"""
from __future__ import annotations

import re

import torch

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

#: torch dtype → the reference's spelling of it
TORCH_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.uint16: "u16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.uint32: "u32", torch.float32: "f32",
    torch.int64: "s64", torch.uint64: "u64", torch.float64: "f64",
    torch.complex64: "c64", torch.complex128: "c128",
}

SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def type_str(shape, dtype: torch.dtype) -> str:
    """The reference's type string of one tensor: ``bf16[16,4096]``."""
    return f"{TORCH_DTYPE_NAMES[dtype]}[{','.join(str(int(d)) for d in shape)}]"


def shape_dims(type_str: str) -> list[tuple[str, list[int]]]:
    """All (dtype, dims) groups in an HLO type string (handles tuples)."""
    out = []
    for dt, dims in SHAPE_RE.findall(type_str):
        if dt not in DTYPE_BYTES:
            continue
        d = [int(x) for x in dims.split(",") if x.strip()]
        out.append((dt, d))
    return out


def shape_bytes(type_str: str) -> int:
    """Total byte size of every shape group in an HLO type string."""
    total = 0
    for dt, dims in shape_dims(type_str):
        n = 1
        for d in dims:
            n *= d
        total += n * DTYPE_BYTES[dt]
    return total
