"""The samplers' counter-based streams (medgp_tpu_torch/infer/streams.py)
and the property they give `hmc_cohort`: every patient's draws are its
own, whatever bucket or batch mates it has.

  * Philox4x32-10 against the Random123 known-answer vectors and an
    independent pure-Python Philox on random counters and keys;
  * the same position gives the same bits, and every other seed, patient,
    chain, step, slot or element gives other bits;
  * 10^5 uniforms and normals: mean and variance within 5 standard
    errors;
  * a NUTS row whose tree ends early draws the same, alone or beside a
    row whose tree goes deeper;
  * `hmc_cohort` with HMC, NUTS and VI on a cohort of 6 patients (LMC-SM
    Q=1, D=2, R=1, 20-60 observations, MAP files from the ground-truth
    hypers): every patient's draws bitwise equal in one bucket, in buckets
    of 4 with the patients in reversed order, and one patient a bucket.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from medgp_tpu_torch.config.experiment import generate_experiment  # noqa: E402
from medgp_tpu_torch.data import formats  # noqa: E402
from medgp_tpu_torch.data.synthetic import (  # noqa: E402
    cluster_thetas, sample_cohort, write_reference_format_cohort,
)
from medgp_tpu_torch.infer import nuts as tnuts  # noqa: E402
from medgp_tpu_torch.infer import streams as st  # noqa: E402
from medgp_tpu_torch.models.params import LMCSMSpec  # noqa: E402
from medgp_tpu_torch.parallel.runner import hmc_cohort  # noqa: E402

M32 = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32 at 10 rounds: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def philox_python(c, k):
    """Philox4x32-10 on Python integers (the 64-bit product whole)."""
    c, k = list(c), list(k)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1], p0 & M32]
    return c


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    c, k, want = KAT[case]
    assert [int(x) for x in st.philox(*c, *k)] == list(want)
    assert philox_python(c, k) == list(want)


def test_philox_matches_python_on_random_counters():
    rng = np.random.default_rng(0)
    cs = rng.integers(0, 2**32, size=(4, 257), dtype=np.int64)
    ks = rng.integers(0, 2**32, size=(2, 257), dtype=np.int64)
    got = st.philox(*(torch.as_tensor(x) for x in cs), *(torch.as_tensor(x) for x in ks))
    for j in range(cs.shape[1]):
        assert [int(w[j]) for w in got] == philox_python(cs[:, j].tolist(), ks[:, j].tolist())


def test_same_position_same_bits_and_every_other_differs():
    """words() at every (seed, patient, chain, step, slot, element) of a
    grid: repeated calls agree, a row's words do not depend on the rows
    beside it, and no two positions share their 64 bits."""
    keys = [0, 1, 2, st.PAD_KEY]
    seen = {}
    for seed in (0, 1):
        s = st.with_chains(st.patient_streams(seed, keys), 3)
        for step in (0, 1, 7):
            blocks = ((st.HMC_MOMENTUM, 5), (st.HMC_ACCEPT, 1), (st.NUTS_SUBTREE, 3))
            out = st.words(s, step, blocks)
            again = st.words(s, step, blocks)
            for (a0, a1), (b0, b1) in zip(out, again):
                assert torch.equal(a0, b0) and torch.equal(a1, b1)
            alone = st.words(st.Streams(seed, s.key[4:5], s.chain[4:5]), step, blocks)
            for (a0, a1), (b0, b1) in zip(out, alone):
                assert torch.equal(a0[4:5], b0) and torch.equal(a1[4:5], b1)
            for (slot, _), (w0, w1) in zip(blocks, out):
                for row in range(w0.shape[0]):
                    for j in range(w0.shape[1]):
                        pos = (seed, int(s.key[row]), int(s.chain[row]), step, slot, j)
                        seen[(int(w0[row, j]) << 32) | int(w1[row, j])] = pos
    assert len(seen) == 2 * len(keys) * 3 * 3 * 9


def test_uniform_and_normal_moments():
    """10^5 draws of each, from one stream's elements: mean and variance
    within 5 standard errors; uniforms in [0, 1), integers cover 0..m-1."""
    n = 100_000
    s = st.patient_streams(718, [3])
    ((w0, w1),) = st.words(s, 0, ((st.VI_DRAWS, n),))
    u = st.uniform(w0, torch.float64)[0].numpy()
    z = st.normal(w0, w1, torch.float64)[0].numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) <= 5 * np.sqrt(1 / 12 / n)
    assert abs(u.var() - 1 / 12) <= 5 * np.sqrt(1 / 180 / n)  # Var of (U - 1/2)^2
    assert abs(z.mean()) <= 5 / np.sqrt(n)
    assert abs(z.var() - 1.0) <= 5 * np.sqrt(2 / n)
    k = st.below(w0, 7)[0].numpy()
    assert sorted(set(k.tolist())) == list(range(7))
    assert np.all(np.abs(np.bincount(k) / n - 1 / 7) <= 5 * np.sqrt(1 / 7 * 6 / 7 / n))
    z32 = st.normal(w0, w1, torch.float32)[0].numpy()
    np.testing.assert_allclose(z32, z, rtol=1e-5, atol=1e-5)


def test_finished_nuts_row_does_not_advance():
    """One NUTS transition of row 0 (a step size that turns in a few
    leaves) alone and beside a row whose small steps double to the depth
    cap: row 0's draw, acceptance and depth are the same, though the batch
    ran more leaves."""
    def pg(x):
        return 0.5 * torch.sum(x * x, -1), x

    H, depth = 3, 6
    theta = torch.tensor([[0.3, -0.2, 0.5], [0.1, 0.4, -0.3]], dtype=torch.float64)
    u, g = pg(theta)
    eps = torch.tensor([0.9, 0.002], dtype=torch.float64)
    s = st.patient_streams(5, [11, 12])
    f64 = dict(dtype=torch.float64)
    args = (torch.ones(2, H, **f64), torch.ones(H, **f64), depth, 1000.0)
    both = tnuts._nuts_transition(pg, theta, u, g, s, 3, eps, *args)
    alone = tnuts._nuts_transition(
        pg, theta[:1], u[:1], g[:1], st.Streams(5, s.key[:1], s.chain[:1]), 3, eps[:1],
        *(a[:1] if isinstance(a, torch.Tensor) and a.dim() == 2 else a for a in args))
    assert int(both[5][1]) > int(both[5][0])  # the mate's tree goes deeper
    assert both[7] > alone[7]  # so the batch reads more
    for x, y in zip(both[:7], alone[:7]):
        assert torch.equal(x[:1], y)


Q, D, R = 1, 2, 1
N_PATIENTS = 6
BUDGET = {
    "hmc": dict(num_chains=2, num_warmup=4, num_samples=4, num_leapfrog=4),
    "nuts": dict(num_chains=2, num_warmup=4, num_samples=4, max_depth=3),
    "vi": dict(num_warmup=6, num_samples=4),
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """6 synthetic patients of 20-60 observations, an experiment over them
    and MAP files at each patient's cluster's ground truth, jittered."""
    root = str(tmp_path_factory.mktemp("streams"))
    spec = LMCSMSpec(Q, D, R)
    recs = sample_cohort(21, spec, N_PATIENTS, n_clusters=2, n_obs_range=(20, 60))
    write_reference_format_cohort(os.path.join(root, "data", "synth"), recs, [18, 19])
    cfg = generate_experiment(
        data_root=os.path.join(root, "data"), exp_root=os.path.join(root, "exp"),
        cohort="synth", feature_list=[18, 19], Q=Q, R=R, cv_fold_num=2, exp_prefix="streams")
    truth = cluster_thetas(21, spec, 2)
    rng = np.random.default_rng(4)
    for i, r in enumerate(recs):
        theta = truth[i % 2] + 0.01 * rng.normal(size=spec.n_hyp)
        formats.write_train_result(cfg.exp_train_dir, r.pan, theta, theta, None, True, r.n_obs)
    assert sorted(r.pan for r in recs) == sorted(cfg.pans())
    return cfg, recs


@pytest.mark.parametrize("sampler", sorted(BUDGET))
def test_draws_do_not_depend_on_the_bucket(cohort, sampler):
    cfg, recs = cohort
    runs = [
        hmc_cohort(cfg, recs, write=False, device="cpu", sampler=sampler, max_batch=32,
                   seed=3, **BUDGET[sampler]),
        hmc_cohort(cfg, recs[::-1], write=False, device="cpu", sampler=sampler, max_batch=4,
                   seed=3, **BUDGET[sampler]),
        hmc_cohort(cfg, recs, write=False, device="cpu", sampler=sampler, max_batch=1,
                   seed=3, **BUDGET[sampler]),
    ]
    other_seed = hmc_cohort(cfg, recs[:1], write=False, device="cpu", sampler=sampler,
                            seed=4, **BUDGET[sampler])
    for r in recs:
        first = runs[0][r.pan]["samples"]
        assert np.isfinite(first).all()
        for other in runs[1:]:
            np.testing.assert_array_equal(other[r.pan]["samples"], first, err_msg=r.pan)
    assert not np.array_equal(other_seed[recs[0].pan]["samples"], runs[0][recs[0].pan]["samples"])
