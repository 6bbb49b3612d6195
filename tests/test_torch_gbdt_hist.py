"""synapseml_torch.gbdt.hist against the JAX package's GBDT histograms.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode, ``_level_histogram`` with each backend) and through the
port's backends on the CPU, where ``impl='pallas'`` takes the CUDA kernel's
plain version (fixed-point sums, bit for bit what the kernel computes).
Tolerance rtol/atol 1e-5, as ``tests/test_gbdt.py:980``; the count channel
is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_torch.gbdt import hist
from synapseml_tpu.gbdt.pallas_hist import pallas_segment_histogram
from synapseml_tpu.gbdt.trees import _level_histogram

N, F, W, B = 300, 4, 4, 16
BASE = 3


def _level_inputs(seed=0, bin_dtype=np.uint8, n=N, nf=F, nb=B):
    rs = np.random.default_rng(seed)
    bins = rs.integers(0, nb, (n, nf)).astype(bin_dtype)
    grad = rs.normal(size=n).astype(np.float32)
    hess = rs.uniform(0.01, 0.25, n).astype(np.float32)
    presence = (rs.random(n) < 0.9).astype(np.float32)
    # nodes 0..14: the level holds 3..6, the rest sit outside it
    node = rs.integers(0, 15, n).astype(np.int32)
    return bins, grad, hess, presence, node


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,wb", [(513, 130), (2048, 512), (100, 31 * 8)])
def test_segment_histogram_matches_the_pallas_kernel(n, wb):
    rs = np.random.default_rng(7)
    seg = rs.integers(0, wb + 5, n).astype(np.int32)  # some out of range
    data = rs.normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(pallas_segment_histogram(jnp.asarray(seg), jnp.asarray(data), wb))
    got = hist.segment_histogram(*_torch(seg, data), wb)
    assert got.shape == (wb, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bin_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("impl", hist.HIST_IMPLS)
def test_level_histogram_matches_jax(impl, bin_dtype):
    bins, grad, hess, presence, node = _level_inputs(bin_dtype=bin_dtype)
    want = np.asarray(_level_histogram(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(presence),
        jnp.asarray(node), BASE, W, B, hist_impl="pallas"))
    got = hist.level_histogram(*_torch(bins, grad, hess, presence, node), BASE, W, B,
                               impl=impl)
    assert got.shape == (W, F, B, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., 2].numpy(), want[..., 2])  # counts exact


@pytest.mark.parametrize("impl", hist.HIST_IMPLS)
def test_node_totals_match_the_level_sums(impl):
    _, grad, hess, presence, node = _level_inputs(seed=1)
    valid = (node >= BASE) & (node < BASE + W)
    want = np.zeros((W, 3), np.float64)
    np.add.at(want, node[valid] - BASE, np.stack([grad, hess, presence], 1)[valid])
    got = hist.node_totals(*_torch(grad, hess, presence, node), BASE, W, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fixed_point_sums_do_not_depend_on_row_order():
    """The kernel's determinism rests on integer sums: permuting the rows
    gives bitwise the same histogram, where float sums may differ."""
    bins, grad, hess, presence, node = _level_inputs(seed=2, n=4000)
    perm = np.random.default_rng(3).permutation(4000)
    a = hist.fixed_point_histogram_plain(*_torch(bins, grad, hess, presence, node), BASE, W, B)
    b = hist.fixed_point_histogram_plain(*_torch(bins[perm], grad[perm], hess[perm],
                                                 presence[perm], node[perm]), BASE, W, B)
    assert torch.equal(a, b)


def test_fixed_point_scale_keeps_large_and_tiny_values():
    """One scale per channel from max|value| and N: a channel of huge values
    cannot overflow int64, and a channel of tiny ones keeps its precision."""
    n = 1000
    rs = np.random.default_rng(4)
    bins = rs.integers(0, 8, (n, 1)).astype(np.uint8)
    grad = (rs.normal(size=n) * 1e30).astype(np.float32)
    hess = (rs.random(n) * 1e-30).astype(np.float32)
    presence = np.ones(n, np.float32)
    node = np.zeros(n, np.int32)
    got = hist.fixed_point_histogram_plain(*_torch(bins, grad, hess, presence, node), 0, 1, 8)
    want = np.zeros((8, 3))
    np.add.at(want, bins[:, 0], np.stack([grad, hess, presence], 1).astype(np.float64))
    np.testing.assert_allclose(got[0, 0].numpy(), want, rtol=1e-6)


def test_out_of_range_bins_and_empty_input_add_nothing():
    seg = torch.tensor([-1, 0, 3, 4, 9], dtype=torch.int32)
    data = torch.ones((5, 3))
    got = hist.segment_histogram(seg, data, 4)
    np.testing.assert_array_equal(got[:, 2].numpy(), [1, 0, 0, 1])
    empty = hist.segment_histogram(torch.zeros(0, dtype=torch.int32), torch.zeros((0, 3)), 4)
    assert torch.equal(empty, torch.zeros((4, 3)))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    bins, grad, hess, presence, node = _torch(*_level_inputs(seed=5))
    before = hist.fixed_point_histogram.launches
    got = hist.fixed_point_histogram(bins, grad, hess, presence, node, BASE, W, B)
    assert hist.fixed_point_histogram.launches == before
    assert torch.equal(got, hist.fixed_point_histogram_plain(bins, grad, hess, presence,
                                                             node, BASE, W, B))


def test_kernel_argument_checks():
    bins, grad, hess, presence, node = _torch(*_level_inputs(seed=6))
    check = hist._check_kernel_args
    check(bins, grad, hess, presence, node, BASE, W, B)
    with pytest.raises(TypeError, match="bins must be uint8 or int32"):
        check(bins.long(), grad, hess, presence, node, BASE, W, B)
    with pytest.raises(TypeError, match="node_of_row must be torch.int32"):
        check(bins, grad, hess, presence, node.long(), BASE, W, B)
    with pytest.raises(ValueError, match="must be contiguous"):
        check(bins.t().contiguous().t(), grad, hess, presence, node, BASE, W, B)
    with pytest.raises(ValueError, match=r"hess must be \(300,\)"):
        check(bins, grad, hess[:10], presence, node, BASE, W, B)
    with pytest.raises(ValueError, match="bins=None takes num_bins=1"):
        check(None, grad, hess, presence, node, BASE, W, B)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        hist.fixed_point_histogram(bins.to("meta"), grad.to("meta"), hess.to("meta"),
                                   presence.to("meta"), node.to("meta"), BASE, W, B)
    with pytest.raises(ValueError, match="hist_impl must be"):
        hist.level_histogram(bins, grad, hess, presence, node, BASE, W, B, impl="xla")


@pytest.mark.parametrize("width", [1, 4, 32])
def test_plain_version_with_the_tree_scale_equals_its_own_scale(width):
    """The per-tree scale passed in gives bitwise the histogram of the scale
    computed from the same rows inside the call, at narrow and wide levels."""
    bins, grad, hess, presence, node = _torch(*_level_inputs(seed=8, n=2000, nb=B))
    node = torch.from_numpy(np.random.default_rng(9).integers(
        0, 2 * width + 3, 2000).astype(np.int32))  # rows in and outside the level
    scale = hist.fixed_point_scales(grad, hess, presence)
    assert scale.dtype == torch.int32 and scale.shape == (3,)
    assert scale.tolist() == hist._scale_exps(torch.stack([grad, hess, presence], 1))
    got = hist.fixed_point_histogram_plain(bins, grad, hess, presence, node, width - 1,
                                           width, B, scale)
    want = hist.fixed_point_histogram_plain(bins, grad, hess, presence, node, width - 1,
                                            width, B)
    assert torch.equal(got, want)
    tree = hist.fixed_point_tree(grad, hess, presence, F, 6, B)
    assert tree.scratch is None and torch.equal(tree.scale, scale)
    assert torch.equal(hist.level_histogram(bins, grad, hess, presence, node, width - 1, width,
                                            B, impl="pallas", tree=tree), want)
    assert torch.equal(hist.node_totals(grad, hess, presence, node, width - 1, width,
                                        impl="pallas", tree=tree),
                       hist.fixed_point_histogram_plain(None, grad, hess, presence, node,
                                                        width - 1, width, 1)[:, 0, 0])


def test_kernel_argument_checks_refuse_a_malformed_scale():
    bins, grad, hess, presence, node = _torch(*_level_inputs(seed=10))
    check = hist._check_kernel_args
    scale = hist.fixed_point_scales(grad, hess, presence)
    check(bins, grad, hess, presence, node, BASE, W, B, scale)
    for bad in (scale.long(), scale.float(), scale[:2], torch.zeros(4, dtype=torch.int32),
                scale.reshape(3, 1), torch.zeros(6, dtype=torch.int32)[::2],
                scale.to("meta")):
        with pytest.raises(ValueError, match=r"scale must be a contiguous \(3,\) int32"):
            check(bins, grad, hess, presence, node, BASE, W, B, bad)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        hist.fixed_point_scales(grad.to("meta"), hess.to("meta"), presence.to("meta"))
