"""The fused scan kernel compiled through Triton, on the card.

These need a GPU and skip elsewhere; their CPU counterparts (interpret
mode) are in test_pallas_scan.py."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _case(gpu_device, n, d, b, seed=0):
    import jax
    import jax.numpy as jnp

    kx, kq = jax.random.split(jax.random.PRNGKey(seed))
    with jax.default_device(gpu_device):
        x = jax.random.normal(kx, (n, d), jnp.float32)
        q = jax.random.normal(kq, (b, d), jnp.float32)
        return x, q, jnp.sum(x * x, axis=1), jnp.ones(n, bool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_kernel_matches_xla_on_gpu(gpu_device, dtype):
    import jax
    import jax.numpy as jnp

    from pyrope_tpu.ops.distance import score_matrix
    from pyrope_tpu.ops.pallas_scan import interpret_mode, pallas_flat_topk
    from pyrope_tpu.types import Metric

    assert not interpret_mode()
    x, q, sq, alive = _case(gpu_device, 50_000, 128, 64)
    xs = x.astype(dtype)
    vals, idx = pallas_flat_topk(q, xs, sq, alive, 50_000, k=10)
    cd = None if dtype == "float32" else jnp.bfloat16
    ref_v, ref_i = jax.lax.top_k(
        score_matrix(q, xs, Metric.L2, x_sqnorm=sq, compute_dtype=cd), 10)
    assert (np.asarray(idx) == np.asarray(ref_i)).mean() >= 0.999
    np.testing.assert_allclose(np.asarray(vals), np.asarray(ref_v),
                               rtol=1e-4, atol=1e-3)


def test_ivf_kernel_matches_mask_on_gpu(gpu_device):
    import jax
    import jax.numpy as jnp

    from pyrope_tpu.index.ivf_flat import dense_probe_mask, probe_budget_table
    from pyrope_tpu.ops.distance import score_matrix
    from pyrope_tpu.ops.pallas_scan import pallas_ivf_topk
    from pyrope_tpu.ops.topk import masked_topk
    from pyrope_tpu.types import Metric

    n, nlist, nprobe, b = 40_000, 50, 8, 96
    x, q, sq, alive = _case(gpu_device, n, 96, b, seed=1)
    rng = np.random.default_rng(0)
    crow = np.sort(rng.integers(0, nlist, n)).astype(np.int32)
    lens = np.bincount(crow, minlength=nlist)
    pos = (np.arange(n) - (np.cumsum(lens) - lens)[crow]).astype(np.int32)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False)
                      for _ in range(b)]).astype(np.int32)
    eff = np.minimum(lens[probe], 300).astype(np.int32)
    with jax.default_device(gpu_device):
        crow, pos, probe, eff = map(jnp.asarray, (crow, pos, probe, eff))
        allowed = probe_budget_table(probe, eff, nlist)
        _, idx = pallas_ivf_topk(q, x, sq, alive, crow, pos, allowed, k=10)
        mask = dense_probe_mask(probe, eff, crow, pos, alive, nlist)
        _, ref = masked_topk(score_matrix(q, x, Metric.L2, x_sqnorm=sq),
                             mask, 10)
    assert (np.asarray(idx) == np.asarray(ref)).mean() >= 0.999


def test_flat_kernel_beyond_int32_elements_on_gpu(gpu_device):
    """A bf16 slab of 16.8M x 128 (past 2^31 elements, 4.3 GB): queries
    equal to rows at the far end find those rows first, and the top-10
    agrees with XLA's bf16 scan."""
    import jax
    import jax.numpy as jnp

    from pyrope_tpu.ops.distance import score_matrix
    from pyrope_tpu.ops.pallas_scan import pallas_flat_topk
    from pyrope_tpu.types import Metric

    n, d, b = 2**31 // 128 + 4096, 128, 64
    planted = np.arange(n - 1, n - 1 - 4 * b, -4)[:b]
    with jax.default_device(gpu_device):
        x = jax.random.normal(jax.random.PRNGKey(5), (n, d), jnp.bfloat16)
        sq = jnp.sum(jnp.square(x.astype(jnp.float32)), axis=1)
        q = x[jnp.asarray(planted)].astype(jnp.float32)
        vals, idx = pallas_flat_topk(q, x, sq, jnp.ones(n, bool), n, k=10)
        ref_v, ref_i = jax.lax.top_k(score_matrix(
            q, x, Metric.L2, x_sqnorm=sq, compute_dtype=jnp.bfloat16), 10)
    idx = np.asarray(idx)
    assert (idx[:, 0] == planted).all()
    # bf16 near-ties may order differently; the scores must agree per rank
    assert (idx == np.asarray(ref_i)).mean() >= 0.99
    np.testing.assert_allclose(np.asarray(vals), np.asarray(ref_v),
                               rtol=1e-4, atol=1e-3)
