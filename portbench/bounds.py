"""The yardstick's peaks and byte counts, frozen here so that no change to the
program can move them.

Peaks: one NVIDIA H100 SXM, from its data sheet (dense rates at 700 W):
3.35 TB/s of HBM3 and 67 TFLOP/s of fp32 outside the tensor cores. The byte
counts copy the arithmetic of ``cuembed_tpu_torch/utils/benchmarking.py``'s
``forward_bound`` and ``backward_bound``: each distinct row read once, the
index streams read once, each output written once; no L2 repeat counts.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INDEX_BYTES = 8  # int64 ids
SID_BYTES = 4  # K3's int32 sample ids
GRAD_BYTES = 4  # fp32 gradient rows


def lookup_bytes(*, unique_rows: int, ids: int, out_rows: int, width: int, elem: int) -> int:
    """One pooled lookup of one table: the distinct rows read once, the ids
    read once, the pooled output written once."""
    return unique_rows * width * elem + ids * INDEX_BYTES + out_rows * width * elem


def k1_bound_s(*, unique_rows: int, ids: int, out_rows: int, width: int, elem: int) -> float:
    """``forward_bound``: the larger of the bytes over the HBM rate and one
    fp32 add an element looked up over the fp32 rate."""
    nbytes = lookup_bytes(unique_rows=unique_rows, ids=ids, out_rows=out_rows, width=width,
                          elem=elem)
    return max(nbytes / HBM_BYTES_PER_S, ids * width / FP32_FLOP_PER_S)


def k3_bound_s(*, gy_rows: int, width: int, live: int, unique_rows: int) -> float:
    """``backward_bound`` in compressed mode, unweighted, fp32 ``grad_y``:
    the gradient rows read once, the sorted index and sample-id streams read
    once, each distinct row's sum written once with its index."""
    row = width * GRAD_BYTES
    nbytes = gy_rows * row + live * (INDEX_BYTES + SID_BYTES) + unique_rows * (row + INDEX_BYTES)
    return max(nbytes / HBM_BYTES_PER_S, live * width / FP32_FLOP_PER_S)


def step_bytes(*, unique_rows: int, ids: int, batch: int, width: int, elem: int) -> int:
    """One row-wise AdaGrad training step of one table: the lookup's bytes,
    ``grad_y`` read once, each touched row written once and its fp32
    accumulator read and written once. The sort's streams are not counted:
    they are one implementation's choice."""
    return (lookup_bytes(unique_rows=unique_rows, ids=ids, out_rows=batch, width=width, elem=elem)
            + batch * width * GRAD_BYTES + unique_rows * (width * elem + 2 * 4))
