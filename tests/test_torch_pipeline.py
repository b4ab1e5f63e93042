"""The port's ``InputPipeline`` against ``cuembed_tpu.utils.pipeline``: the
same remapped batches in the same order from the same source, the partial
dict remap, the errors (a failing source, a starved queue, depth < 1), the
iteration and the context manager; and ``to_device``'s tensors. The side
stream and its event need a card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from cuembed_tpu.utils.pipeline import InputPipeline as JPipeline
from cuembed_tpu_torch.utils.pipeline import InputPipeline, to_device


def _batches(seed, n=5):
    rng = np.random.default_rng(seed)
    return rng.permutation(100).astype(np.int32), [
        rng.integers(0, 100, (4, 3)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_remaps_and_orders_as_jax(depth):
    remap, batches = _batches(depth)
    outs = []
    for cls in (InputPipeline, JPipeline):
        it = iter(batches)
        with cls(lambda: next(it), remap=remap, depth=depth) as pipe:
            outs.append([pipe.get() for _ in batches])
    for got, want, raw in zip(*outs, batches):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, remap[raw])


def test_dict_batches_partial_remap_and_iteration():
    rng = np.random.default_rng(1)
    remap = rng.permutation(50).astype(np.int32)
    batches = [{"a": rng.integers(0, 50, (4,)).astype(np.int32),
                "b": rng.integers(0, 50, (4,)).astype(np.int32)} for _ in range(3)]
    outs = []
    for cls in (InputPipeline, JPipeline):
        it = iter(batches)
        with cls(lambda: next(it), remap={"a": remap}, depth=1) as pipe:
            outs.append(list(pipe))  # StopIteration from the source ends it
    assert len(outs[0]) == len(outs[1]) == 3
    for got, want, raw in zip(*outs, batches):
        np.testing.assert_array_equal(got["a"], want["a"])
        np.testing.assert_array_equal(got["a"], remap[raw["a"]])
        np.testing.assert_array_equal(got["b"], raw["b"])


def test_errors_match_jax():
    def boom():
        raise RuntimeError("source died")

    for cls in (InputPipeline, JPipeline):
        with cls(boom, depth=1) as pipe:
            with pytest.raises(RuntimeError, match="source died"):
                pipe.get(timeout=5.0)
        with pytest.raises(ValueError, match="depth"):
            cls(boom, depth=0)

    def slow():
        import time
        time.sleep(1.0)
        return np.zeros(2, np.int32)

    with InputPipeline(slow, depth=1) as pipe:
        with pytest.raises(TimeoutError, match="starved"):
            pipe.get(timeout=0.2)
    assert not pipe._thread.is_alive()


def test_device_put_gives_tensors():
    remap, batches = _batches(3)
    it = iter(batches)
    put = to_device("cpu")
    with InputPipeline(lambda: {"x": next(it), "d": np.ones(2, np.float32)},
                       remap={"x": remap}, device_put=put) as pipe:
        for raw in batches:
            got = pipe.get()
            assert isinstance(got["x"], torch.Tensor) and got["x"].dtype == torch.int32
            np.testing.assert_array_equal(got["x"].numpy(), remap[raw])
            assert got["d"].dtype == torch.float32
    one = put(batches[0])
    assert isinstance(one, torch.Tensor) and not one.is_pinned()
