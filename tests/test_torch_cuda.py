"""K1, K2 and K3 on the card against their plain versions.

Marked ``cuda``: run on a machine with an NVIDIA GPU with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. Without a card
every test skips (decided in a fixture, so that every pytest worker
collects the same tests).
"""

import pytest
import torch

import cuembed_tpu_torch as tce
from cuembed_tpu_torch.ops import cuda_backward, cuda_forward
from cuembed_tpu_torch.ops.lookup_torch import (
    SENTINEL,
    embedding_backward_compressed_torch,
    embedding_backward_torch,
    embedding_forward_torch,
    rounded_reciprocal,
)
from cuembed_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


TYPES = [
    (torch.float32, False), (torch.float16, False), (torch.float16, True),
    (torch.bfloat16, False), (torch.bfloat16, True),
]


@pytest.mark.parametrize("width", [2, 7, 36, 256, 514])
@pytest.mark.parametrize("dtype,lpm", TYPES)
@pytest.mark.parametrize("mode", ["sum", "sum_w", "mean"])
def test_kernels_equal_plain_version(gen, mode, dtype, lpm, width):
    """Same order, same rounding: bit for bit on random reals."""
    V, B, H = 500, 67, 19
    m = tce.CombineMode(mode.removesuffix("_w"))
    table = torch.randn((V, width), device="cuda", generator=gen).to(dtype)
    for index_dtype in (torch.int32, torch.int64):
        idx = torch.randint(0, V, (B, H), device="cuda", generator=gen).to(index_dtype)
        w = (torch.rand((B, H), device="cuda", generator=gen)
             if mode == "sum_w" else None)
        got = cuda_forward.embedding_forward_cuda(
            table, idx, w, mode=m, low_precision_math=lpm)
        want = embedding_forward_torch(table, idx, None, w, mode=m,
                                       low_precision_math=lpm)
        assert torch.equal(got, want)

        hots = torch.randint(0, H + 1, (B,), device="cuda", generator=gen)
        hots[:3] = 0
        offsets = torch.cat([hots.new_zeros(1), hots.cumsum(0)]).to(index_dtype)
        cap = int(offsets[-1]) + 11
        flat = torch.randint(0, V, (cap,), device="cuda", generator=gen).to(index_dtype)
        fw = (torch.rand(cap, device="cuda", generator=gen)
              if mode == "sum_w" else None)
        got = cuda_forward.embedding_forward_cuda_csr(
            table, flat, offsets, fw, mode=m, low_precision_math=lpm)
        want = embedding_forward_torch(table, flat, offsets, fw, mode=m,
                                       low_precision_math=lpm)
        assert torch.equal(got, want)
        assert not got[:3].any()


def test_auto_routes_cuda_tensors_to_the_kernels(gen):
    table = torch.randn((100, 64), device="cuda", generator=gen)
    idx = torch.randint(0, 100, (8, 4), device="cuda", generator=gen)
    offsets = torch.tensor([0, 3, 3, 9], device="cuda")
    flat = torch.randint(0, 100, (12,), device="cuda", generator=gen)
    k1, k2 = (trace.counters()["launch.k1"],
              trace.counters()["launch.k2"])
    for backend in ("auto", "pallas"):
        tce.embedding_lookup(table, idx, backend=backend)
        tce.embedding_lookup_csr(table, flat, offsets, backend=backend)
    tce.embedding_lookup(table, idx, backend="xla")
    tce.embedding_lookup(table, idx, mode=tce.CombineMode.CONCAT)
    assert trace.counters()["launch.k1"] == k1 + 2
    assert trace.counters()["launch.k2"] == k2 + 2


def test_module_defaults_to_the_card(gen):
    bag = tce.EmbeddingBag(1000, 32)
    assert bag.weight.device.type == "cuda"
    idx = torch.randint(0, 1000, (16, 8), device="cuda", generator=gen)
    with torch.inference_mode():
        out = bag(idx)
    assert torch.equal(out, embedding_forward_torch(bag.weight.detach(), idx))


@pytest.mark.parametrize("shift", [1, 2], ids=["scalar", "8-byte"])
def test_misaligned_table_takes_a_narrower_load(gen, shift):
    """A table view that starts 4 (8) bytes into its storage cannot take
    16-byte loads; the wrapper picks a load width the pointers allow."""
    base = torch.randn((101, 64), device="cuda", generator=gen)
    table = base.reshape(-1)[shift:shift + 100 * 64].reshape(100, 64)
    idx = torch.randint(0, 100, (9, 5), device="cuda", generator=gen)
    got = cuda_forward.embedding_forward_cuda(table, idx)
    assert torch.equal(got, embedding_forward_torch(table, idx))


def _csr_of(lengths, V, gen, pad=5):
    """Offsets of bags of the given lengths, in order, and random ids with
    ``pad`` entries of capacity padding."""
    hots = torch.tensor(lengths, device="cuda")
    offsets = torch.cat([hots.new_zeros(1), hots.cumsum(0)])
    flat = torch.randint(0, V, (int(offsets[-1]) + pad,), device="cuda", generator=gen)
    return flat, offsets


def _forward_equals_plain(table, idx, offsets, gen, lpm, modes=("sum", "sum_w", "mean")):
    """K1 (offsets None) or K2 on these ids, in each mode, bit for bit
    against the plain version."""
    for mode in modes:
        w = torch.rand(idx.shape, device="cuda", generator=gen) if mode == "sum_w" else None
        m = tce.CombineMode(mode.removesuffix("_w"))
        if offsets is None:
            got = cuda_forward.embedding_forward_cuda(table, idx, w, mode=m,
                                                      low_precision_math=lpm)
        else:
            got = cuda_forward.embedding_forward_cuda_csr(table, idx, offsets, w, mode=m,
                                                          low_precision_math=lpm)
        want = embedding_forward_torch(table, idx, offsets, w, mode=m, low_precision_math=lpm)
        assert torch.equal(got, want), (mode, tuple(idx.shape))


@pytest.mark.parametrize("dtype,lpm", TYPES)
def test_long_bags(gen, dtype, lpm):
    """Bags far longer than a worker's 32 staged positions: fixed hotness
    2100, and a CSR batch where one bag of 5000 holds most positions beside
    short and empty ones."""
    V = 300
    table = torch.randn((V, 64), device="cuda", generator=gen).to(dtype)
    idx = torch.randint(0, V, (3, 2100), device="cuda", generator=gen)
    _forward_equals_plain(table, idx, None, gen, lpm)
    flat, offsets = _csr_of([5000, 3, 0, 2100, 1, 33], V, gen)
    _forward_equals_plain(table, flat, offsets, gen, lpm)


@pytest.mark.parametrize("dtype,lpm", TYPES)
def test_zero_hotness_batch_is_zeros(gen, dtype, lpm):
    table = torch.randn((50, 256), device="cuda", generator=gen).to(dtype)
    idx = torch.zeros((9, 0), dtype=torch.int64, device="cuda")
    _forward_equals_plain(table, idx, None, gen, lpm, modes=("sum", "sum_w"))
    assert not cuda_forward.embedding_forward_cuda(table, idx).any()


@pytest.mark.parametrize("dtype,lpm", TYPES)
@pytest.mark.parametrize("ids", ["one row", "four rows"])
def test_repeated_rows(gen, dtype, lpm, ids):
    """Width 256 at hotness 64, every id on one row or on four: every load
    after the first hits on chip."""
    V = 1000
    table = torch.randn((V, 256), device="cuda", generator=gen).to(dtype)
    if ids == "one row":
        idx = torch.full((70, 64), 617, device="cuda")
    else:
        idx = torch.randint(0, 4, (70, 64), device="cuda", generator=gen) * 211
    _forward_equals_plain(table, idx, None, gen, lpm)
    hots = torch.randint(0, 65, (70,), device="cuda", generator=gen)
    offsets = torch.cat([hots.new_zeros(1), hots.cumsum(0)])
    _forward_equals_plain(table, idx.reshape(-1), offsets, gen, lpm)


@pytest.mark.parametrize("batch", [1, 9, 33, 257])
@pytest.mark.parametrize("width,dtype", [(256, torch.float16), (32, torch.float32),
                                         (514, torch.float32)])
def test_batches_off_the_block_size(gen, batch, width, dtype):
    """Batches that do not fill the last block's workers (a warp a bag at
    width 256 fp16, 8 lanes at 32 fp32, 17 slabs at 514 fp32)."""
    table = torch.randn((400, width), device="cuda", generator=gen).to(dtype)
    idx = torch.randint(0, 400, (batch, 13), device="cuda", generator=gen)
    _forward_equals_plain(table, idx, None, gen, False)
    hots = torch.randint(0, 27, (batch,), device="cuda", generator=gen)
    offsets = torch.cat([hots.new_zeros(1), hots.cumsum(0)])
    flat = torch.randint(0, 400, (int(offsets[-1]) + 2,), device="cuda", generator=gen)
    _forward_equals_plain(table, flat, offsets, gen, False)


# (dtype, low-precision math, element offset of the table view, load width).
ROUTE_VIEWS = [(torch.float32, False, 2, 8), (torch.float32, False, 1, 4),
               (torch.float16, False, 4, 8), (torch.float16, True, 4, 8),
               (torch.float16, False, 1, 2), (torch.float16, True, 1, 2),
               (torch.bfloat16, True, 4, 8), (torch.bfloat16, True, 1, 2)]


@pytest.mark.parametrize("dtype,lpm,shift,vec", ROUTE_VIEWS,
                         ids=[f"{str(d)[6:]}-lpm{int(lp)}-{v}B" for d, lp, _, v in ROUTE_VIEWS])
def test_misaligned_tables_take_each_load_width(gen, dtype, lpm, shift, vec):
    """A table view ``shift`` elements into its storage takes 8-byte or
    one-element loads (under low-precision math a one-element vector rides
    in half a packed word), K1 and K2 alike, bit for bit."""
    base = torch.randn((201 * 256,), device="cuda", generator=gen).to(dtype)
    table = base[shift:shift + 200 * 256].view(200, 256)
    out = torch.empty((1, 256), dtype=dtype, device="cuda")
    size = table.element_size()
    assert cuda_forward._vec_bytes(256 * size | table.data_ptr() | out.data_ptr(), size) == vec
    idx = torch.randint(0, 200, (37, 19), device="cuda", generator=gen)
    _forward_equals_plain(table, idx, None, gen, lpm)
    hots = torch.randint(0, 20, (37,), device="cuda", generator=gen)
    offsets = torch.cat([hots.new_zeros(1), hots.cumsum(0)]).int()
    _forward_equals_plain(table, idx.reshape(-1), offsets, gen, lpm)


def test_launch_shape_fits_the_card(gen):
    """The flagship launch shapes from the built library: no spills, a few
    KB of shared memory, several blocks resident per SM."""
    for csr, weighted in ((False, False), (True, True)):
        shape = cuda_forward.launch_shape(torch.float16, 256, 65536, csr=csr,
                                          weighted=weighted)
        assert shape["spill_bytes"] == 0
        assert shape["smem_bytes"] <= 4096
        assert shape["blocks_per_sm"] >= 2


def _sorted_coo(gen, n, V, rows, index_dtype, *, long_run=0, pad=0):
    """An index-sorted COO of n live entries (the first ``long_run`` share
    one index, a run over several tiles) and ``pad`` sentinel entries."""
    idx = torch.randint(0, V, (n,), device="cuda", generator=gen)
    idx[:long_run] = 7
    sid = torch.randint(0, rows, (n,), device="cuda", generator=gen)
    order = torch.sort(idx, stable=True).indices
    t_idx = torch.cat([idx[order], torch.full((pad,), SENTINEL, device="cuda")])
    t_sid = torch.cat([sid[order], torch.zeros(pad, dtype=sid.dtype, device="cuda")])
    return t_idx.to(index_dtype), t_sid.to(torch.int32)


def _live(cg):
    """The entries of a compressed gradient below its count, the only ones
    K3 writes: ``(rows, unique_indices)``."""
    nu = min(int(cg.num_unique), cg.rows.shape[0])
    return cg.rows[:nu], cg.unique_indices[:nu]


def _integer_problem(gen, dtype, width, index_dtype, weighted, V=200, rows=64,
                     n=1500, pad=5):
    """Integer-exact data: every partial sum is exact in fp32 and in the
    half types (values in {-1, 0, 1}, weights in {0.5, 1}; for fp16/bf16
    seven in eight values are 0, so that the partial sums of the long run
    stay well inside bf16's 8 bits)."""
    t_idx, t_sid = _sorted_coo(gen, n, V, rows, index_dtype,
                               long_run=3 * cuda_backward.TILE + 50, pad=pad)
    gy = torch.randint(-1, 2, (rows, width), device="cuda", generator=gen)
    if dtype != torch.float32:
        gy *= torch.rand((rows, width), device="cuda", generator=gen) < 0.125
    gy = gy.to(dtype)
    w = None
    if weighted:
        w = torch.tensor([0.5, 1.0], device="cuda")[
            torch.randint(0, 2, t_idx.shape, device="cuda", generator=gen)]
    return gy, t_idx, t_sid, w


@pytest.mark.parametrize("width", [2, 36, 256, 514])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_k3_full_equals_plain_version(gen, weighted, dtype, width):
    """Bitwise on integer-exact data, with a run over three tiles, sentinel
    padding, an nnz prefix and an initial gradient."""
    V = 200
    for index_dtype in (torch.int32, torch.int64):
        gy, t_idx, t_sid, w = _integer_problem(gen, dtype, width, index_dtype, weighted)
        for nnz in (None, t_idx.shape[0] - 40):
            got = cuda_backward.embedding_backward_cuda(gy, V, t_idx, t_sid, w, nnz=nnz)
            want = embedding_backward_torch(gy, V, t_idx, t_sid, w, nnz=nnz)
            assert torch.equal(got, want)
        init = torch.randint(-2, 3, (V, width), device="cuda", generator=gen).to(dtype)
        got = cuda_backward.embedding_backward_cuda(gy, V, t_idx, t_sid, w,
                                                    initial_grad=init.clone())
        want = embedding_backward_torch(gy, V, t_idx, t_sid, w, initial_grad=init.clone())
        assert torch.equal(got, want)


@pytest.mark.parametrize("width", [2, 36, 256, 514])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_k3_compressed_equals_plain_version(gen, weighted, dtype, width):
    """Every run of the live prefix, the sentinel's included, gets its rank."""
    for index_dtype in (torch.int32, torch.int64):
        gy, t_idx, t_sid, w = _integer_problem(gen, dtype, width, index_dtype, weighted)
        for nnz in (None, t_idx.shape[0] - 3, 0):
            got = cuda_backward.embedding_backward_cuda_compressed(gy, t_idx, t_sid, w,
                                                                   nnz=nnz)
            want = embedding_backward_compressed_torch(gy, t_idx, t_sid, w, nnz=nnz)
            assert int(got.num_unique) == int(want.num_unique)
            for a, b in zip(_live(got), _live(want)):
                assert torch.equal(a, b)


def test_k3_is_deterministic(gen):
    """Random reals, long runs: two launches give the same bits, and both
    modes stay within the fp32 recursive-sum bound of a float64 sum."""
    V, rows, width, n = 1000, 4096, 256, 200_000
    t_idx, t_sid = _sorted_coo(gen, n, V, rows, torch.int64, long_run=60_000)
    gy = torch.randn((rows, width), device="cuda", generator=gen)
    w = torch.rand(n, device="cuda", generator=gen)
    first = cuda_backward.embedding_backward_cuda(gy, V, t_idx, t_sid, w)
    assert torch.equal(first, cuda_backward.embedding_backward_cuda(gy, V, t_idx, t_sid, w))
    c1 = cuda_backward.embedding_backward_cuda_compressed(gy, t_idx, t_sid, w)
    c2 = cuda_backward.embedding_backward_cuda_compressed(gy, t_idx, t_sid, w)
    assert torch.equal(_live(c1)[0], _live(c2)[0])
    terms = gy.double()[t_sid.long()] * w.double()[:, None]
    exact = torch.zeros((V, width), dtype=torch.float64, device="cuda")
    exact.index_add_(0, t_idx, terms)
    mass = torch.zeros_like(exact).index_add_(0, t_idx, terms.abs())
    count = torch.bincount(t_idx, minlength=V).double()[:, None]
    # n - 1 adds and one multiply per term, each within 2^-24 relative.
    assert ((first.double() - exact).abs() <= (count + 1) * 2.0**-24 * mass).all()
    nu = int(c1.num_unique)
    assert torch.equal(first[c1.unique_indices[:nu]], c1.rows[:nu])


def test_autograd_backward_runs_k3(gen):
    table = torch.randn((300, 64), device="cuda", generator=gen).requires_grad_()
    idx = torch.randint(0, 300, (32, 8), device="cuda", generator=gen)
    before = trace.counters()["launch.k3_full"]
    tce.embedding_lookup(table, idx).pow(2).sum().backward()
    assert trace.counters()["launch.k3_full"] == before + 1
    ref = table.detach().clone().requires_grad_()
    tce.embedding_lookup(ref, idx, backend="xla").pow(2).sum().backward()
    torch.testing.assert_close(table.grad, ref.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_half_table_gradient_skips_the_fp32_gradient(gen, mode, dtype):
    """K3 takes a half grad_y as it is: the gradient equals K3 on the fp32
    cast of grad_y, rounded once to the half type, bit for bit."""
    V, W = 400, 64
    table = torch.randn((V, W), device="cuda", generator=gen).to(dtype).requires_grad_()
    idx = torch.randint(0, V, (96, 7), device="cuda", generator=gen)
    m = tce.CombineMode(mode)
    out = tce.embedding_lookup(table, idx, mode=m)
    gy = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
    out.backward(gy)
    rows_in = gy * rounded_reciprocal(7, dtype) if mode == "mean" else gy
    sid = torch.arange(idx.numel(), dtype=torch.int32, device="cuda") // 7
    t_idx, t_sid, _ = tce.transpose(sid, idx.reshape(-1))
    want = cuda_backward.embedding_backward_cuda(rows_in.float(), V, t_idx, t_sid).to(dtype)
    assert table.grad.dtype == dtype
    assert torch.equal(table.grad, want)


def test_optimizer_state_defaults_to_the_card(gen):
    assert tce.rowwise_adagrad_init(100).device.type == "cuda"
    assert all(t.device.type == "cuda" for t in tce.adam_init(100, 8))


def _shifted(gy, shift_bytes):
    """``gy`` copied into a view that starts ``shift_bytes`` into its
    storage, so that K3 must take a narrower copy route."""
    shift = shift_bytes // gy.element_size()
    base = torch.zeros(gy.numel() + shift, dtype=gy.dtype, device=gy.device)
    view = base[shift:].view(gy.shape)
    view.copy_(gy)
    return view


# (dtype, byte offset of grad_y, the copy route it takes at width 256).
ROUTE_CASES = [
    (torch.float32, 0, 16), (torch.float32, 8, 8), (torch.float32, 4, 4),
    (torch.bfloat16, 0, 16), (torch.bfloat16, 8, 8), (torch.bfloat16, 4, 4),
    (torch.float16, 2, 2),
]


@pytest.mark.parametrize("dtype,shift,route", ROUTE_CASES,
                         ids=[f"{str(d)[6:]}-{cuda_backward.ROUTES[r]}" for d, _, r in ROUTE_CASES])
def test_k3_copy_routes_equal_plain_version(gen, dtype, shift, route):
    """Each copy route (bulk, cp.async 8 and 4 bytes, plain 2-byte loads),
    picked by a misaligned grad_y view, in full mode (into a zeroed output
    and into an initial gradient) and compressed mode: bit for bit on
    integer-exact data, and two launches give the same bits."""
    V, width = 200, 256
    gy, t_idx, t_sid, w = _integer_problem(gen, dtype, width, torch.int64, True)
    gy = _shifted(gy, shift)
    init = torch.randint(-2, 3, (V, width), device="cuda", generator=gen).to(dtype)
    assert cuda_backward.vec_bytes(gy, init) == route
    for start in (None, init):
        got = [cuda_backward.embedding_backward_cuda(
            gy, V, t_idx, t_sid, w, initial_grad=None if start is None else start.clone())
            for _ in range(2)]
        want = embedding_backward_torch(gy, V, t_idx, t_sid, w,
                                        initial_grad=None if start is None else start.clone())
        assert torch.equal(got[0], got[1])
        assert torch.equal(got[0], want)
    got = [cuda_backward.embedding_backward_cuda_compressed(gy, t_idx, t_sid, w)
           for _ in range(2)]
    want = embedding_backward_compressed_torch(gy, t_idx, t_sid, w)
    assert int(got[0].num_unique) == int(want.num_unique)
    assert torch.equal(_live(got[0])[0], _live(got[1])[0])
    for a, b in zip(_live(got[0]), _live(want)):
        assert torch.equal(a, b)


def _run_lengths_coo(lengths, rows, index_dtype, gen):
    """A sorted COO whose runs have the given lengths, in order, over
    indices 0, 1, 2, ..."""
    lengths = torch.tensor(lengths, device="cuda")
    t_idx = torch.repeat_interleave(torch.arange(lengths.numel(), device="cuda"), lengths)
    t_sid = torch.randint(0, rows, t_idx.shape, device="cuda", generator=gen)
    return t_idx.to(index_dtype), t_sid.to(torch.int32)


@pytest.mark.parametrize("width", [64, 256, 514])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_runs_across_stages_and_tiles(gen, dtype, width):
    """Runs that end on, before and after a ring stage's edge (8 positions)
    and a tile's edge, runs over several tiles, and a whole tile of
    one-position runs; full and compressed, bit for bit on integer-exact
    data, two launches equal."""
    T = cuda_backward.TILE
    lengths = ([1] * T + [7, 8, 9, 1, 16, 17] + [T - 48, T, T + 1, 1, 3 * T + 5]
               + [1] * (T + 3) + [2 * T - 1, 5])
    V = len(lengths)
    rows = 96
    t_idx, t_sid = _run_lengths_coo(lengths, rows, torch.int32, gen)
    gy = torch.randint(-1, 2, (rows, width), device="cuda", generator=gen)
    if dtype != torch.float32:
        gy *= torch.rand((rows, width), device="cuda", generator=gen) < 0.125
    gy = gy.to(dtype)
    w = torch.tensor([0.5, 1.0], device="cuda")[
        torch.randint(0, 2, t_idx.shape, device="cuda", generator=gen)]
    for coeff in (None, w):
        got = [cuda_backward.embedding_backward_cuda(gy, V, t_idx, t_sid, coeff)
               for _ in range(2)]
        assert torch.equal(got[0], got[1])
        assert torch.equal(got[0], embedding_backward_torch(gy, V, t_idx, t_sid, coeff))
        c = [cuda_backward.embedding_backward_cuda_compressed(gy, t_idx, t_sid, coeff)
             for _ in range(2)]
        want = embedding_backward_compressed_torch(gy, t_idx, t_sid, coeff)
        assert int(c[0].num_unique) == int(want.num_unique) == V
        assert torch.equal(_live(c[0])[0], _live(c[1])[0])
        for a, b in zip(_live(c[0]), _live(want)):
            assert torch.equal(a, b)


# -- the TPU engines' routes (tiered, narrow, int8) on the kernels ---------------

TIERED_CFG = tce.TieredConfig(hot_rows=128, chunk_elems=64, cold_slots=32,
                              mxu_head_rows=32, mid_slots=32)


def _integer_table(gen, V, W, dtype=torch.float32):
    return torch.randint(-8, 9, (V, W), device="cuda", generator=gen).to(dtype)


def test_tiered_forward_runs_k1_and_k2(gen):
    """backend="tiered" launches K1 (fixed) and K2 (CSR) on the whole table,
    and equals "auto" and the plain version bit for bit."""
    table = torch.randn((1000, 256), device="cuda", generator=gen).half()
    idx = torch.randint(0, 1000, (64, 8), device="cuda", generator=gen)
    w = torch.rand((64, 8), device="cuda", generator=gen)
    offsets = torch.tensor([0, 3, 3, 9, 20], device="cuda")
    flat = torch.randint(0, 1000, (24,), device="cuda", generator=gen)
    before = trace.counters()
    got = tce.embedding_lookup(table, idx, w, backend="tiered", tiered_cfg=TIERED_CFG)
    got_csr = tce.embedding_lookup_csr(table, flat, offsets, backend="tiered",
                                       tiered_cfg=tce.csr_combine_config(1000, 16))
    after = trace.counters()
    assert [after[k] - before[k] for k in ("launch.k1", "launch.k2")] == [1, 1]
    assert torch.equal(got, tce.embedding_lookup(table, idx, w))
    assert torch.equal(got, embedding_forward_torch(table, idx, None, w))
    assert torch.equal(got_csr, embedding_forward_torch(table, flat, offsets))


def test_narrow_lookup_runs_k1_on_the_view(gen, monkeypatch):
    """A packed table's lookup hands K1 the packed storage itself (its
    [ceil(V/k)*k, W] view), and equals the raw table's lookup."""
    from cuembed_tpu_torch.ops import narrow

    table = torch.randn((1001, 32), device="cuda", generator=gen)
    packed = narrow.pack_narrow(table)
    idx = torch.randint(0, 1001, (128, 8), device="cuda", generator=gen)
    seen = []
    real = cuda_forward.embedding_forward_cuda

    def spy(t, *args, **kwargs):
        seen.append((t.data_ptr(), tuple(t.shape)))
        return real(t, *args, **kwargs)

    monkeypatch.setattr(cuda_forward, "embedding_forward_cuda", spy)
    got = narrow.narrow_lookup(packed, 1001, 32, idx, tiered_cfg=TIERED_CFG)
    assert seen == [(packed.data_ptr(), (1004, 32))]
    assert torch.equal(got, real(table, idx))
    bag = tce.EmbeddingBag.from_numpy(table.cpu().numpy(), layout="packed")
    assert torch.equal(bag(idx), got)


def test_tiered_backward_runs_k3(gen):
    """The tiered backward, the head product plus K3 over the non-head
    positions (the head masked to the sentinel, which K3 drops), equals the
    untiered K3 gradient on integer data; the lookup's gradient with a
    tiered_cfg is the untiered one (one K3 launch over the whole COO)."""
    from cuembed_tpu_torch.ops.head import tiered_backward_coo
    from cuembed_tpu_torch.ops.transforms import transpose_position_ordered

    for dtype in (torch.float32, torch.bfloat16):
        table = _integer_table(gen, 1000, 256, dtype)
        idx = torch.randint(0, 1000, (256, 8), device="cuda", generator=gen)
        idx[:, :3] %= 32  # head traffic
        gy = torch.randint(-3, 4, (256, 256), device="cuda", generator=gen).to(dtype)
        grads = []
        for cfg in (TIERED_CFG, None):
            t = table.clone().requires_grad_()
            before = trace.counters()["launch.k3_full"]
            (tce.embedding_lookup(t, idx, tiered_cfg=cfg) * gy).float().sum().backward()
            assert trace.counters()["launch.k3_full"] == before + 1
            grads.append(t.grad)
        assert torch.equal(*grads)
        flat = idx.reshape(-1)
        masked = torch.where(flat < TIERED_CFG.mxu_head_rows, SENTINEL, flat)
        sid = torch.arange(flat.numel(), device="cuda", dtype=torch.int32) // 8
        before = trace.counters()["launch.k3_full"]
        split = tiered_backward_coo(gy, 1000, idx, None,
                                    *transpose_position_ordered(sid, masked), TIERED_CFG,
                                    accumulation_dtype=torch.float32)
        assert trace.counters()["launch.k3_full"] == before + 1
        assert split.dtype == dtype and torch.equal(split, grads[1])


def test_compressed_tiered_keeps_the_sentinel_run_out(gen):
    """K3's compressed mode keeps out-of-range runs; the tiered compressed
    gradient bounds it at the non-sentinel count, so the masked head is no
    unique row: equal to the plain version on the CPU."""
    from cuembed_tpu_torch.ops.lookup_torch import embedding_backward_compressed_tiered
    from cuembed_tpu_torch.ops.transforms import transpose_position_ordered

    idx = torch.randint(0, 1000, (256, 8), device="cuda", generator=gen)
    idx[:, :4] %= 32
    gy = torch.randint(-3, 4, (256, 128), device="cuda", generator=gen).float()
    coeff = torch.randint(0, 3, (256, 8), device="cuda", generator=gen).float()
    flat = torch.where(idx < 32, SENTINEL, idx).reshape(-1)
    sid = torch.arange(flat.numel(), device="cuda", dtype=torch.int32) // 8
    coo = transpose_position_ordered(sid, flat, coeff.reshape(-1))
    before = trace.counters()["launch.k3_compressed"]
    got = embedding_backward_compressed_tiered(gy, 1000, idx, coeff, *coo, TIERED_CFG)
    assert trace.counters()["launch.k3_compressed"] == before + 1
    want = embedding_backward_compressed_tiered(
        gy.cpu(), 1000, idx.cpu(), coeff.cpu(), *(t.cpu() for t in coo), TIERED_CFG)
    nu = int(want.num_unique)
    assert int(got.num_unique) == nu and nu < int(torch.unique(idx).numel()) + 1
    assert torch.equal(got.unique_indices.cpu(), want.unique_indices)
    assert torch.equal(got.rows.cpu(), want.rows)
    assert (got.unique_indices[:nu] != SENTINEL).all()


def test_head_product_is_ieee_fp32(gen):
    """With TF32 allowed, the head product still rounds as fp32 (TF32
    would keep 10 significand bits: errors near 1e-3)."""
    from cuembed_tpu_torch.ops.head import head_grad

    idx = torch.randint(0, 64, (4096, 4), device="cuda", generator=gen)
    gy = torch.randn((4096, 256), device="cuda", generator=gen)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = head_grad(idx, None, gy, 64, torch.float32)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    want = head_grad(idx.cpu(), None, gy.double().cpu(), 64, torch.float64)
    torch.testing.assert_close(got.double().cpu(), want, rtol=1e-5, atol=1e-4)


def test_tiered_sparse_steps_equal_the_cpu(gen):
    """Tiered SGD and AdaGrad on the card equal the same steps on the CPU,
    integer data: untiered sums under "fallback", the head product and K3
    compressed under "drop"."""
    from cuembed_tpu_torch import train

    table = _integer_table(gen, 1000, 64)
    idx = torch.randint(0, 1000, (256, 8), device="cuda", generator=gen)
    idx[:, :3] %= 32
    gy = torch.randint(-3, 4, (256, 64), device="cuda", generator=gen).float()
    for step, overflow in (("sgd", "fallback"), ("sgd", "drop"), ("adagrad", "fallback"),
                           ("adagrad", "drop")):
        got, want = table.clone(), table.cpu()
        if step == "sgd":
            kw = dict(lr=0.5, tiered_cfg=TIERED_CFG, overflow=overflow)
            train.sgd_sparse_update(got, idx, gy, **kw)
            train.sgd_sparse_update(want, idx.cpu(), gy.cpu(), **kw)
        else:
            kw = dict(lr=0.1, tiered_cfg=TIERED_CFG, overflow=overflow, unique_cap=200)
            acc = train.rowwise_adagrad_init(1000)
            acc_cpu = train.rowwise_adagrad_init(1000, device="cpu")
            train.rowwise_adagrad_sparse_update(got, acc, idx, gy, **kw)
            train.rowwise_adagrad_sparse_update(want, acc_cpu, idx.cpu(), gy.cpu(), **kw)
            assert torch.equal(acc.cpu(), acc_cpu)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)


def test_int8_lookups_on_the_card(gen):
    """int8_serving_lookup and tiered_forward(q_head=...) on CUDA tensors
    against the same functions on the CPU (fp32 sums in the same order)."""
    from cuembed_tpu_torch.ops import quant

    table = torch.randn((4000, 256), device="cuda", generator=gen)
    idx = (torch.rand((64, 8), device="cuda", generator=gen) ** 3 * 4000).long()
    qt = quant.quantize_head(table)
    assert torch.equal(qt.data.cpu(), quant.quantize_head(table.cpu()).data)
    got = quant.int8_serving_lookup(qt, idx)
    want = quant.int8_serving_lookup(quant.QuantizedHead(qt.data.cpu()), idx.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    cfg = tce.TieredConfig(hot_rows=512, chunk_elems=64, cold_slots=64, mxu_head_rows=64,
                           mid_slots=64)
    qh = quant.quantize_head(table[:1024])
    got = tce.tiered_forward(table, idx, cfg=cfg, q_head=qh)
    want = tce.tiered_forward(table.cpu(), idx.cpu(), cfg=cfg,
                              q_head=quant.QuantizedHead(qh.data.cpu()))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-5)


def _counts():
    c = trace.counters()
    return tuple(c[k] for k in ("launch.k1", "launch.k2", "launch.k3_full",
                                "launch.k3_compressed"))


def _launched(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def test_table_lookups_and_update_run_the_kernels(gen):
    """EmbeddingTable on the card: the reorder stays on the card, lookups
    after calibrate (device remap and host remap) launch K1 once each and
    equal the lookup before it bit for bit; the CSR lookup launches K2; an
    AdaGrad step on the table launches K3 compressed and equals the step on
    the CPU on integer data."""
    from cuembed_tpu_torch import train
    from cuembed_tpu_torch.table import EmbeddingTable, resize_table

    t = EmbeddingTable(_integer_table(gen, 20_000, 64), layout="raw", hot_bytes=65536,
                       vmem_table_bytes=1024)
    idx = (torch.rand((512, 16), device="cuda", generator=gen) ** 3 * 20_000).long()
    offsets = torch.tensor([0, 5, 5, 40, 41], device="cuda")
    flat = idx.reshape(-1)[:64].contiguous()
    ref, ref_csr = t.lookup(idx), t.lookup(flat, offsets=offsets)
    t.calibrate(idx)
    assert t.table.is_cuda and t.tiered_cfg is not None
    before = _counts()
    got = t.lookup(idx)
    got_pipe = t.lookup(t.remap_indices(idx), assume_remapped=True)
    got_csr = t.lookup(flat, offsets=offsets)
    assert _launched(before) == (2, 1, 0, 0)
    assert torch.equal(got, ref) and torch.equal(got_pipe, ref)
    assert torch.equal(got_csr, ref_csr)
    gy = torch.randint(-3, 4, (512, 64), device="cuda", generator=gen).float()
    rows = t.remap_indices(idx)
    want_t, want_a = t.table.cpu(), torch.zeros(20_000)
    acc = train.rowwise_adagrad_init(20_000)
    before = _counts()
    train.rowwise_adagrad_sparse_update(t.table, acc, rows, gy, lr=0.1)
    assert _launched(before) == (0, 0, 0, 1)
    train.rowwise_adagrad_sparse_update(want_t, want_a, rows.cpu(), gy.cpu(), lr=0.1)
    torch.testing.assert_close(acc.cpu(), want_a, rtol=1e-6, atol=0)
    torch.testing.assert_close(t.table.cpu(), want_t, rtol=1e-6, atol=1e-6)
    grown, grown_acc = resize_table(t.table, 21_000, gen, accum=acc)
    assert grown.is_cuda and torch.equal(grown[:20_000], t.table)
    assert not grown_acc[20_000:].any()


def test_fused_group_is_one_launch(gen):
    """fused_lookup launches K1 once and equals the per-table lookups of
    EmbeddingCollection.apply bit for bit under SUM; fused_adagrad_update
    launches K3 compressed once and equals the per-table updates."""
    from cuembed_tpu_torch.collection import EmbeddingCollection, TableConfig

    names = [f"t{i}" for i in range(4)]
    coll = EmbeddingCollection([TableConfig(n, 5000, 64, hotness=8) for n in names])
    tables = coll.init(gen)
    idx = {n: torch.randint(0, 5000, (1024, 8), device="cuda", generator=gen)
           for n in names}
    fused, spec = tce.fuse_tables(tables, {n: 8 for n in names})
    before = _counts()
    got = tce.fused_lookup(fused, spec, idx)
    assert _launched(before) == (1, 0, 0, 0)
    want = coll.apply(tables, idx)
    assert _launched(before) == (5, 0, 0, 0)
    assert all(torch.equal(got[n], want[n]) for n in names)
    gy = {n: torch.randint(-3, 4, (1024, 64), device="cuda", generator=gen).float()
          for n in names}
    accum = tce.rowwise_adagrad_init(spec.total_rows)
    before = _counts()
    _, got_accum = tce.fused_adagrad_update(fused, accum, spec, idx, gy, lr=0.1)
    assert _launched(before) == (0, 0, 0, 1)
    _, accums = coll.adagrad_update(tables, coll.adagrad_init(), idx, gy, lr=0.1)
    parts = tce.unfuse_table(fused, spec)
    for n, b, s in zip(spec.names, spec.bases, spec.sizes):
        torch.testing.assert_close(parts[n], tables[n], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(got_accum[b:b + s], accums[n], rtol=1e-6, atol=0)


def test_dlrm_step_runs_k3_full(gen):
    """The DLRM's sgd_step on the card: one K1 and one K3 full launch a
    step with fused storage, one each a table without; the loss and the
    step equal the CPU model's from the same parameters."""
    from cuembed_tpu_torch.models import DLRM, DLRMConfig

    base = dict(table_sizes=(3000, 2000, 5000), embed_width=32, hotness=4,
                dense_features=8, bottom_mlp=(16, 32), top_mlp=(16, 1))
    dense = torch.randn((256, 8), device="cuda", generator=gen)
    sparse = [torch.randint(0, v, (256, 4), device="cuda", generator=gen)
              for v in base["table_sizes"]]
    labels = torch.randint(0, 2, (256,), device="cuda", generator=gen).float()
    for fused, launches in ((True, (1, 0, 1, 0)), (False, (3, 0, 3, 0))):
        m = DLRM(DLRMConfig(**base, fused=fused))
        m.reset_parameters(gen)
        cpu = DLRM(DLRMConfig(**base, fused=fused), device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        before = _counts()
        loss = m.sgd_step(dense, sparse, labels, lr=0.05)
        assert _launched(before) == launches
        want = cpu.sgd_step(dense.cpu(), [s.cpu() for s in sparse], labels.cpu(), lr=0.05)
        torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=1e-6)
        for (name, p), q in zip(m.named_parameters(), cpu.parameters()):
            torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=1e-5, atol=1e-6,
                                       msg=name)


def test_pipeline_hands_over_on_the_callers_stream(gen):
    """Batches copied on the pipeline's side stream from pinned memory are
    ready on the caller's stream: the same values as the host remap, each
    tensor on the card."""
    import numpy as np

    from cuembed_tpu_torch.utils.pipeline import InputPipeline, to_device

    rng = np.random.default_rng(0)
    remap = rng.permutation(10_000).astype(np.int32)
    batches = [rng.integers(0, 10_000, (4096, 8)).astype(np.int32) for _ in range(6)]
    it = iter(batches)
    with InputPipeline(lambda: {"x": next(it)}, remap={"x": remap}, depth=3,
                       device_put=to_device("cuda")) as pipe:
        for raw in batches:
            got = pipe.get()["x"]
            assert got.is_cuda
            doubled = got * 2  # a kernel on the caller's stream reads it
            assert torch.equal(doubled.cpu(), torch.from_numpy(remap[raw]) * 2)


def test_offloaded_lookup_and_step_run_the_kernels(gen):
    """The host-offloaded table on the card: the lookup is one K1 launch
    equal to K1 on the resident table bit for bit, and an SGD and an
    AdaGrad step (K3 compressed on the head) match the same table on the
    CPU (the plain path) within fp32 rtol = atol = 1e-5."""
    import numpy as np

    rng = np.random.default_rng(0)
    V, hot, W, B, H = 4096, 1024, 64, 256, 8
    table = rng.standard_normal((V, W)).astype(np.float32)
    idx = np.where(rng.random((B, H)) < 0.7, rng.integers(0, hot, (B, H)),
                   rng.integers(hot, V, (B, H))).astype(np.int32)
    gy = rng.standard_normal((B, W)).astype(np.float32)
    card = tce.HostOffloadTable(table, hot, cold_cap=B * H)
    cpu = tce.HostOffloadTable(table, hot, cold_cap=B * H, device="cpu")
    n1 = trace.counters()["launch.k1"]
    batch = card.prepare(idx)
    got = card.lookup(batch, mode=tce.CombineMode.MEAN)
    assert trace.counters()["launch.k1"] == n1 + 1
    coeff = torch.full((B, H), 1.0 / H, device="cuda")
    want = tce.embedding_lookup(torch.from_numpy(table).cuda(), torch.from_numpy(idx).cuda(),
                                coeff)
    assert torch.equal(got, want)
    n3 = trace.counters()["launch.k3_compressed"]
    card.sgd_update(batch, torch.from_numpy(gy).cuda(), lr=0.1)
    cpu.sgd_update(cpu.prepare(idx), torch.from_numpy(gy), lr=0.1)
    card.adagrad_init()
    cpu.adagrad_init()
    card.adagrad_update(card.prepare(idx), torch.from_numpy(gy).cuda(), lr=0.1)
    cpu.adagrad_update(cpu.prepare(idx), torch.from_numpy(gy), lr=0.1)
    assert trace.counters()["launch.k3_compressed"] == n3 + 2
    np.testing.assert_allclose(card.full_table(), cpu.full_table(), rtol=1e-5, atol=1e-5)


def test_one_rank_nccl_sharded_lookup_and_update(gen, tmp_path):
    """The parallel layer over NCCL at world size 1 on the card: the routed
    and the row-sharded lookups equal the plain lookup bit for bit (one
    rank: the same rows in the same order), and the routed AdaGrad update
    equals the plain path's within fp32 rtol = atol = 1e-5."""
    import torch.distributed as dist

    from cuembed_tpu_torch import parallel, train

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()
        V, W, B, H = 1000, 64, 128, 8
        table = torch.randn((V, W), device="cuda", generator=gen)
        idx = torch.randint(0, V, (B, H), device="cuda", generator=gen)
        w = torch.rand((B, H), device="cuda", generator=gen)
        plain = tce.embedding_lookup(table, idx, w, backend="xla")
        assert torch.equal(parallel.alltoall_row_sharded_lookup(table, idx, w, mesh=mesh),
                           plain)
        assert torch.equal(parallel.row_sharded_lookup(table, idx, w, mesh=mesh), plain)
        gy = torch.randn((B, W), device="cuda", generator=gen)
        t1, a1 = table.clone(), torch.zeros(V, device="cuda")
        t2, a2 = table.clone(), torch.zeros(V, device="cuda")
        parallel.sharded_rowwise_adagrad_sparse_update(t1, a1, idx, gy, mesh=mesh, lr=0.1,
                                                       weights=w)
        train.rowwise_adagrad_sparse_update(t2, a2, idx, gy, lr=0.1, weights=w,
                                            backend="xla")
        torch.testing.assert_close(t1, t2, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a1, a2, rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_stream_rate_and_event_stats(gen):
    """The streaming-reduce rate is a card's (above a tenth of the data
    sheet's peak, below 1.25 times it), and the event timer's statistics
    are ordered and not degenerate."""
    from cuembed_tpu_torch.utils import benchmarking as bench

    peak = bench.detect_hbm_peak_gbps()
    rate = bench.stream_rate_gbps(256)
    assert 0.1 * peak < rate < 1.25 * peak
    x = torch.randn(1 << 24, device="cuda", generator=gen)
    st = bench.cuda_time_ms(lambda: x.sum(), warmup=1, iters=5, return_stats=True)
    assert 0 < st["min"] <= st["median"] <= st["max"] and not st["degenerate"]
    floor = bench.plausible_floor_s(x.numel() * 4, peak)
    assert not bench.measure_until_plausible(
        lambda: bench.cuda_time_ms(lambda: x.sum(), warmup=1, iters=5, return_stats=True),
        floor)["implausible"]


PLANNED_V, PLANNED_W, PLANNED_B, PLANNED_H = 3000, 64, 256, 8


def _planned_problem():
    g = torch.Generator().manual_seed(1)
    return (torch.randn((PLANNED_V, PLANNED_W), generator=g),
            torch.randint(0, PLANNED_V, (PLANNED_B, PLANNED_H), generator=g),
            torch.randn((PLANNED_B, PLANNED_W), generator=g))


def replicated_ranks(rank, world, tmp):
    """A rank of the replicated planned updates on cuda:0 over gloo."""
    from cuembed_tpu_torch.parallel import (CostModel, apply_plan, local_block, make_mesh,
                                            plan, planned_adagrad_init,
                                            planned_adagrad_update, planned_sgd_update)

    torch.cuda.set_device(0)
    mesh = make_mesh(n_model=world)
    cfg = tce.TableConfig("t", PLANNED_V, PLANNED_W, hotness=PLANNED_H)
    p = plan([cfg], world, batch=PLANNED_B,
             cost=CostModel(replicate_bytes_max=PLANNED_V * 128 * 4))
    table, idx, gy = (x.cuda() for x in _planned_problem())
    ib, gb = ({"t": local_block(x, mesh, ("model", None))} for x in (idx, gy))
    placed = apply_plan(p, {"t": table}, mesh)
    n3 = trace.counters()["launch.k3_compressed"]
    sgd = planned_sgd_update(p, {"t": placed["t"].clone()}, ib, gb, mesh=mesh, lr=0.1)["t"]
    t, a = planned_adagrad_update(p, placed, planned_adagrad_init(p, placed, mesh), ib, gb,
                                  mesh=mesh, lr=0.1)
    torch.cuda.synchronize()
    return {"placement": p.tables["t"].placement, "sgd": sgd.cpu(), "adagrad": t["t"].cpu(),
            "acc": a["t"].cpu(),
            "k3": trace.counters()["launch.k3_compressed"] - n3}


def test_replicated_planned_updates_are_bitwise_on_every_rank(gen, tmp_path):
    """Two ranks on the card over gloo: a replicated table's planned SGD and
    AdaGrad updates (the batch all-gathered, then K3 compressed on every
    rank) leave the replicas equal bit for bit, and equal to the one-card
    update of the whole batch on K3 (the same inputs in the same order)."""
    from pathlib import Path

    from torch_dist import run_ranks

    from cuembed_tpu_torch import train

    out = run_ranks(Path(__file__), "replicated_ranks", 2, tmp_path, timeout=240.0)
    assert all(r["placement"] == "replicated" and r["k3"] == 2 for r in out)
    for key in ("sgd", "adagrad", "acc"):
        assert torch.equal(out[0][key], out[1][key]), key
    table, idx, gy = (x.cuda() for x in _planned_problem())
    want = train.sgd_sparse_update(table.clone(), idx, gy, lr=0.1)
    want_t, want_a = train.rowwise_adagrad_sparse_update(
        table.clone(), torch.zeros(PLANNED_V, device="cuda"), idx, gy, lr=0.1)
    assert torch.equal(out[0]["sgd"], want.cpu())
    assert torch.equal(out[0]["adagrad"], want_t.cpu())
    assert torch.equal(out[0]["acc"], want_a.cpu())


HYBRID_HOT, HYBRID_ROWS = 20_000, 60_000  # a head past HEAD_GRAD_MXU_MAX_ROWS


def hybrid_ranks(rank, world, tmp):
    """A rank of a (data, model) = (2, 1) mesh on cuda:0 over gloo: one
    hybrid AdaGrad update of the same batch on both data replicas."""
    from cuembed_tpu_torch.parallel import (local_block, make_mesh,
                                            sharded_hybrid_rowwise_adagrad_sparse_update,
                                            split_hybrid_table)

    torch.cuda.set_device(0)
    mesh = make_mesh(n_model=1)
    g = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn((HYBRID_ROWS, 64), device="cuda", generator=g)
    idx = torch.randint(0, HYBRID_HOT, (4096, 8), device="cuda", generator=g)
    gy = torch.randn((4096, 64), device="cuda", generator=g)
    head, tail = split_hybrid_table(table, HYBRID_HOT, 1)
    head, tail = head.clone(), local_block(tail, mesh, ("model", None)).clone()
    hacc, tacc = torch.zeros(HYBRID_HOT, device="cuda"), torch.zeros(tail.shape[0], device="cuda")
    sharded_hybrid_rowwise_adagrad_sparse_update(head, tail, hacc, tacc, idx, gy, mesh=mesh,
                                                 lr=0.1)
    return head.cpu(), hacc.cpu()


def test_hybrid_head_replicas_are_bitwise_along_data(gen, tmp_path):
    """The hybrid head's replicas along the data axis all-reduce over the
    model axis only, so each sums its batch's head gradient itself: a head
    past HEAD_GRAD_MXU_MAX_ROWS is summed on K3 (deterministic), and the two
    replicas agree bit for bit (a scatter-add by atomics did not)."""
    from pathlib import Path

    from torch_dist import run_ranks

    out = run_ranks(Path(__file__), "hybrid_ranks", 2, tmp_path, timeout=240.0)
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


# -- the chained timers: K1 captured as a CUDA graph -------------------------------

def _capture(fn):
    """``fn()`` warmed on a side stream, then captured as a CUDA graph;
    returns the graph and the output it writes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    return g, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("csr", [False, True], ids=["k1", "k2"])
def test_graph_captured_kernel_equals_eager(gen, dtype, csr):
    """A graph-captured K1 (K2) launch equals the eager one bit for bit, and
    a replay reads the ids written into its input since. The capture counts
    one launch; replays count none."""
    V, B, H, W = 5000, 300, 17, 256
    table = torch.randn((V, W), device="cuda", generator=gen).to(dtype)
    idx = torch.randint(0, V, (B, H), device="cuda", generator=gen)
    w = torch.rand((B, H), device="cuda", generator=gen)
    offsets = torch.arange(0, B * H + 1, H, device="cuda")
    if csr:
        counter = "launch.k2"

        def fn():
            return cuda_forward.embedding_forward_cuda_csr(table, idx.view(-1), offsets,
                                                           w.view(-1))
    else:
        counter = "launch.k1"

        def fn():
            return cuda_forward.embedding_forward_cuda(table, idx, w)
    eager = fn()
    before = trace.counters()[counter]
    g, out = _capture(fn)
    assert trace.counters()[counter] == before + 2  # the warm-up and the capture
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    idx.copy_(torch.randint(0, V, (B, H), device="cuda", generator=gen))
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    assert trace.counters()[counter] == before + 2
    assert torch.equal(out, fn())


def test_fori_chain_time_over_a_captured_k1_chain(gen):
    """The flagship K1 request (10M x 256 fp16, 65536 x 64 ids) chained as a
    CUDA graph: a positive time a step; the same slope (within 25%) over two
    disjoint spans of chain lengths, so the chain's time grows in proportion
    to k; and within 2x of one step's ``cuda_time_ms`` (L2 flushed there,
    warm along the chain)."""
    from cuembed_tpu_torch.utils import benchmarking as bench

    rows = 10_000_000
    table = torch.empty((rows, 256), dtype=torch.float16, device="cuda")
    table.uniform_(-0.0625, 0.0625, generator=gen)
    idx = torch.randint(0, rows, (65536, 64), device="cuda", generator=gen)

    def step(carry, table, ids):
        i, dep = carry
        out = cuda_forward.embedding_forward_cuda(table, ids + bench.bump_from(dep))
        return (i + 1, bench.carry_probe(out))

    x0 = (torch.zeros((), dtype=torch.int32, device="cuda"),
          torch.zeros((), dtype=torch.float32, device="cuda"))
    short = bench.fori_chain_time(step, x0, operands=(table, idx), k_lo=2, k_hi=6)
    long = bench.fori_chain_time(step, x0, operands=(table, idx), k_lo=8, k_hi=24)
    one = bench.cuda_time_ms(lambda: step(x0, table, idx)) / 1e3
    assert short > bench.DEGENERATE_SLOPE_S and long > bench.DEGENERATE_SLOPE_S
    assert 0.8 < long / short < 1.25, (short, long)
    assert 0.5 < long / one < 2.0, (long, one)
