"""The port's online imputation (`mean_wo_update`) against the JAX package.

Two padded patients, drawn with numpy from a seed, go through
`medgp_tpu.infer.online.online_impute(update=False)` on both of its
factorization paths (MEDGP_PALLAS_CHOL=0: XLA; =1: the Pallas kernels in
interpret mode, as tests/test_online.py:163-189 runs them) and through the
port's `online_impute`, which batches every (patient, timestamp) system of
the bucket and runs the kernels' plain twins on the CPU.

Tolerances are those of tests/test_online.py:181-188: pred rtol/atol 2e-4
(an LOO mean divides by diag(K_S^{-1}), which amplifies float32 rounding
of the two factorizations), var rtol 2e-3, atol 2e-4; CI flags and the
valid mask must be equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from medgp_tpu.infer import online as jonline  # noqa: E402
from medgp_tpu.models import gp as jgp  # noqa: E402
from medgp_tpu.models import params as jparams  # noqa: E402
from medgp_tpu_torch.data.synthetic import cluster_thetas, sample_cohort  # noqa: E402
from medgp_tpu_torch.infer import online as tonline  # noqa: E402
from medgp_tpu_torch.models import gp as tgp  # noqa: E402
from medgp_tpu_torch.models import params as tparams  # noqa: E402

Q, D, R, N = 2, 3, 1, 128


def _bucket(seed):
    """Two patients padded to n=128, with a timestamp shared by two
    observations (within-timestamp leave-one-out)."""
    spec = tparams.LMCSMSpec(Q, D, R)
    recs = sample_cohort(seed, spec, 2, n_clusters=1, n_obs_range=(60, 110))
    theta = cluster_thetas(seed, spec, 1)[0]
    B = len(recs)
    t = np.zeros((B, N), np.float32)
    y = np.zeros((B, N), np.float32)
    meta = np.zeros((B, N), np.int32)
    mask = np.zeros((B, N), np.float32)
    for i, r in enumerate(recs):
        t[i, : r.n_obs], y[i, : r.n_obs] = r.t, r.y
        meta[i, : r.n_obs], mask[i, : r.n_obs] = r.meta, 1.0
    t[0, 5] = t[0, 4]
    ut = np.zeros((B, N), np.float32)
    uv = np.zeros((B, N), bool)
    for i in range(B):
        ut[i], uv[i] = tonline.unique_times(t[i], mask[i], pad_to=N)
    return theta, t, y, meta, mask, ut, uv


def _port(theta, t, y, meta, mask, ut, uv):
    spec = tparams.LMCSMSpec(Q, D, R)
    data = tgp.PatientData(*map(torch.as_tensor, (t, y, meta, mask)))
    return tonline.online_impute(
        spec, tparams.theta_from_numpy(spec, theta), data,
        torch.as_tensor(ut), torch.as_tensor(uv),
    )


@pytest.mark.parametrize("pallas_chol", ["0", "1"])
def test_online_impute_matches_jax(pallas_chol, monkeypatch):
    monkeypatch.setenv("MEDGP_PALLAS_CHOL", pallas_chol)
    theta, t, y, meta, mask, ut, uv = _bucket(31)
    spec = jparams.LMCSMSpec(Q, D, R)
    theta_j = jnp.asarray(theta, jnp.float32)
    got = _port(theta, t, y, meta, mask, ut, uv)
    for i in range(t.shape[0]):
        data = jgp.PatientData(
            t=jnp.asarray(t[i]), y=jnp.asarray(y[i]),
            meta=jnp.asarray(meta[i]), mask=jnp.asarray(mask[i]),
        )
        want = jonline.online_impute(
            spec, theta_j, data, jnp.asarray(ut[i]), jnp.asarray(uv[i]),
            update=False,
        )
        np.testing.assert_allclose(
            got.pred[i].numpy(), np.asarray(want.pred), rtol=2e-4, atol=2e-4
        )
        np.testing.assert_allclose(
            got.error[i].numpy(), np.asarray(want.error), rtol=2e-4, atol=2e-4
        )
        np.testing.assert_allclose(
            got.var[i].numpy(), np.asarray(want.var), rtol=2e-3, atol=2e-4
        )
        assert np.array_equal(got.ci[i].numpy(), np.asarray(want.ci))
        assert np.array_equal(got.valid[i].numpy(), np.asarray(want.valid))
    # the first observation of each patient has no history: fallback
    assert float(got.pred[0, 0]) == 0.0 and float(got.pred[1, 0]) == 0.0


def test_chunking_does_not_change_results(monkeypatch):
    """Splitting the (patient, timestamp) systems into kernel batches of
    any size (here 7, as a small memory budget would) gives bit-identical
    outputs."""
    args = _bucket(32)
    whole = _port(*args)
    monkeypatch.setattr(tonline, "test_chunk_pairs", lambda n, device: 7)
    chunked = _port(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_update_mode_is_refused():
    theta, t, y, meta, mask, ut, uv = _bucket(33)
    spec = tparams.LMCSMSpec(Q, D, R)
    data = tgp.PatientData(*map(torch.as_tensor, (t, y, meta, mask)))
    with pytest.raises(NotImplementedError, match="training slice"):
        tonline.online_impute(
            spec, tparams.theta_from_numpy(spec, theta), data,
            torch.as_tensor(ut), torch.as_tensor(uv), update=True,
        )
