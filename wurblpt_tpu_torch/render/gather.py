"""Per-lane row gather (P0): ``out[i, :] = table[clamp(idx[i], 0, R - 1), :]``.

The port of the repository's one Pallas kernel, the row-gather probe
``tools/probe_pallas_gather.py:20``, and of the per-lane table gathers of the
render path it stands for: the packed material rows
(:func:`wurblpt_tpu_torch.render.bsdf.gather_material_rows`) and the
per-light MIS rows (:func:`wurblpt_tpu_torch.render.lights.lights_pdf_at_hit`).

`row_gather` launches the CUDA kernel of ``csrc/row_gather.cu`` on CUDA
tensors and runs `row_gather_plain` on CPU tensors. Both copy 4-byte words:
a float32 table may hold int32 bit patterns in some columns, and they come
through unchanged. Indices are clamped to the table, as XLA's gather clamps.
"""

from __future__ import annotations

import torch

from .. import native

_WORD_TYPES = (torch.float32, torch.int32)


def row_gather_plain(table, idx):
    """Plain version of P0: rows `idx` [N] of `table` [R, C], as 4-byte words."""
    words = table.view(torch.int32)[torch.clamp(idx.long(), 0, table.shape[0] - 1)]
    return words.view(table.dtype)


def row_gather(table, idx):
    """Rows `idx` (int32 [N]) of `table` ([R, C] float32 or int32) -> [N, C] (P0)."""
    if table.dtype not in _WORD_TYPES or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"row_gather: need a contiguous 2-D float32 or int32 table, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"row_gather: need contiguous int32 [N] indices, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if table.device != idx.device:
        raise ValueError(f"row_gather: table on {table.device}, indices on {idx.device}")
    if table.shape[0] == 0:
        raise ValueError("row_gather: empty table")
    if idx.device.type == "cpu":
        return row_gather_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"row_gather: no kernel for device {idx.device}")
    lib = native.load_kernels()
    n, cols = idx.shape[0], table.shape[1]
    out = torch.empty((n, cols), dtype=table.dtype, device=idx.device)
    code = lib.wpt_row_gather(table.data_ptr(), table.shape[0], cols, idx.data_ptr(), n,
                              out.data_ptr(), native.stream_ptr(idx))
    native.check(code, "row_gather")
    native.LAUNCHES["row_gather"] += 1
    return out
