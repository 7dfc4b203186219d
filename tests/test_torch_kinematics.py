"""The port's kinematics stage (attpc_engine_tpu_torch.kinematics) against
the JAX package's, on the CPU.

Inputs are made from numpy seeds and go through the JAX function and its
port. XLA's CPU code contracts a * b + c into one fused multiply-add and
rounds sin, cos, arccos and sqrt differently from PyTorch by up to an ulp,
so floats are held to stated tolerances and integers and masks exactly:
four-vectors within 1e-9 MeV absolute, vertices within 1e-12 m, each
distribution's transform within 1e-12 relative of ``sample_jax``.

The port draws its noise from Philox streams keyed per event, not from
threefry keys, so two checks are made: fed the JAX package's noise (through
``KinematicsPipeline._draw_noise``, which these tests replace), the port's
masked resampling loop must reproduce ``_run_batch_jit`` lane for lane; on
its own draws it must match the JAX sampler by distribution.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import attpc_engine_tpu as jpkg
import attpc_engine_tpu.kinematics as JK
import attpc_engine_tpu_torch as tpkg
import attpc_engine_tpu_torch.kinematics as TK
from attpc_engine_tpu.io.kinematics_file import KinematicsReader as JReader
from attpc_engine_tpu.nuclear import GasTarget as JGas
from attpc_engine_tpu_torch.io.kinematics_file import KinematicsReader as TReader
from attpc_engine_tpu_torch.nuclear import GasTarget as TGas

MEV_ATOL = 1e-9
VERTEX_ATOL = 1e-12


def _side(port: bool):
    """(kinematics module, nuclear_map, GasTarget, extra kwargs) of one
    package."""
    if port:
        return TK, tpkg.nuclear_map, TGas, {"device": "cpu"}
    return JK, jpkg.nuclear_map, JGas, {}


def build(case: str, port: bool, **kw):
    """One of the pipelines the tests share, in the JAX package or the port:
    "chain" (tests/test_kinematics.py:47-75), "flagship" (bench.py:160-170),
    "target" (the flagship through the gas of tests/test_kinematics.py:
    253-275), "resample" (12C(d,p) at 16 MeV, Ex uniform in [0, 30] MeV:
    about 0.55 of lanes accepted a draw), "gauss" (12C(d,p) at 16 MeV,
    Ex 3.089 MeV, FWHM 0.2)."""
    K, nm, Gas, extra = _side(port)
    d = nm.get_data
    target = None
    if case == "chain":
        steps = [K.Reaction(d(5, 10), d(2, 3), d(2, 4)),
                 K.Decay(d(5, 9), d(2, 4)), K.Decay(d(3, 5), d(2, 4))]
        exc = [K.ExcitationGaussian(16.8, 0.2), K.ExcitationGaussian(0.0, 1.25),
               K.ExcitationGaussian(0.0, 0.0)]
        beam = 24.0
    elif case in ("flagship", "target"):
        steps = [K.Reaction(d(1, 2), d(6, 12), d(1, 1))]
        exc = [K.ExcitationGaussian(0.0, 0.0)]
        beam = 120.0
        if case == "target":
            target = K.KinematicsTargetMaterial(
                material=Gas([(1, 2, 2)], 300.0, nm), z_range=(0.2, 0.8),
                rho_sigma=0.007)
    elif case in ("resample", "gauss"):
        steps = [K.Reaction(d(6, 12), d(1, 2), d(1, 1))]
        exc = [K.ExcitationUniform(0.0, 30.0) if case == "resample"
               else K.ExcitationGaussian(3.089, 0.2)]
        beam = 16.0
    else:
        raise ValueError(case)
    polar = [K.PolarUniform(0.0, np.pi) for _ in steps]
    return K.KinematicsPipeline(steps, exc, polar, beam, target_material=target,
                                **kw, **extra)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- physics


def test_lise_golden_value():
    """12C(d,p)13C ejectile KE at 16 MeV beam, 20 deg CM vs LISE++ (1 keV),
    tests/test_kinematics.py:25-44, through the port on the CPU."""
    d = tpkg.nuclear_map.get_data
    rxn = TK.Reaction(d(6, 12), d(1, 2), d(1, 1))
    result = rxn.calculate(16.0, np.deg2rad(20.0), 0.0, residual_excitation=0.0,
                           device="cpu")
    assert np.round(result[2].E - result[2].M, decimals=3) == 18.391


def _assert_vectors(got: torch.Tensor, ref, atol: float = MEV_ATOL):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["flagship", "chain", "resample"])
def test_reaction_batch_matches_jax(case):
    """reaction_batch on random beam energies (some below threshold),
    angles and excitations: the allowed mask exact, every component of
    every lane (disallowed ones too) finite and within 1e-9 MeV."""
    rng = np.random.default_rng(1)
    n = 4096
    masses = build(case, False).reaction.masses
    t = rng.uniform(0.05, 1.2, n) * {"flagship": 120.0}.get(case, 24.0)
    polar = rng.uniform(0.0, np.pi, n)
    azim = rng.uniform(0.0, 2 * np.pi, n)
    ex = rng.uniform(0.0, 40.0, n)
    jv, ja = JK.reaction_batch(jnp.asarray(masses), *map(jnp.asarray,
                                                         (t, polar, azim, ex)))
    tv, ta = TK.reaction_batch(masses, *map(_t, (t, polar, azim, ex)))
    ja = np.asarray(ja)
    assert 0 < ja.sum() < n
    np.testing.assert_array_equal(ta.numpy(), ja)
    _assert_vectors(tv, jv)


@pytest.mark.parametrize("parent", ["moving", "at_rest"])
def test_decay_batch_matches_jax(parent):
    """decay_batch of the chain's 9B -> 4He + 5Li: parents from the
    reaction at 24 MeV (moving) or at rest (the boost's b2 = 0 branch),
    with lanes below threshold; the allowed mask exact, every lane finite
    and within 1e-9 MeV."""
    rng = np.random.default_rng(2)
    n = 4096
    pipe = build("chain", False)
    decay = pipe.decays[0]
    m9b = decay.parent.mass
    if parent == "moving":
        rxn = pipe.reaction.masses
        vec, _ = JK.reaction_batch(
            jnp.asarray(rxn), jnp.full(n, 24.0), jnp.asarray(rng.uniform(0, np.pi, n)),
            jnp.asarray(rng.uniform(0, 2 * np.pi, n)),
            jnp.asarray(rng.uniform(0, 6, n)))
        pv = np.asarray(vec[:, 3])
    else:
        pv = np.zeros((n, 4))
        pv[:, 3] = m9b + rng.uniform(0.0, 6.0, n)
    polar = rng.uniform(0.0, np.pi, n)
    azim = rng.uniform(0.0, 2 * np.pi, n)
    ex = rng.uniform(0.0, 4.0, n)
    jv, ja = JK.decay_batch(jnp.asarray(decay.masses), jnp.asarray(pv),
                            *map(jnp.asarray, (polar, azim, ex)))
    tv, ta = TK.decay_batch(decay.masses, *map(_t, (pv, polar, azim, ex)))
    ja = np.asarray(ja)
    assert 0 < ja.sum() < n
    np.testing.assert_array_equal(ta.numpy(), ja)
    _assert_vectors(tv, jv)


# ---------------------------------------------------------- distributions


def _distributions(K, nm):
    rng = np.random.default_rng(3)
    probs = rng.uniform(0.1, 1.0, 36)
    probs /= probs.sum()
    return {
        "gaussian": K.ExcitationGaussian(3.089, 0.2),
        "uniform": K.ExcitationUniform(1.5, 30.0),
        "breit_wigner": K.ExcitationBreitWigner(nm.get_data(6, 13).mass, 3.089,
                                                0.5),
        "polar_uniform": K.PolarUniform(0.3, 2.7),
        "polar_arbitrary": K.PolarArbitrary(np.linspace(0, np.pi, 37)[:-1],
                                            probs, np.pi / 36),
    }


def jax_noise_for(kind: tuple[str, int], key, shape):
    """The JAX package's draws for a distribution of NOISE ``kind`` on
    ``key``, as its sample_jax makes them (PolarArbitrary splits its key,
    angle.py:91-98)."""
    k, count = kind
    if k == "normal":
        return (jax.random.normal(key, shape, dtype=jnp.float64),)
    if count == 1:
        return (jax.random.uniform(key, shape, dtype=jnp.float64),)
    k1, k2 = jax.random.split(key)
    return (jax.random.uniform(k1, shape, dtype=jnp.float64),
            jax.random.uniform(k2, shape, dtype=jnp.float64))


@pytest.mark.parametrize("name", ["gaussian", "uniform", "breit_wigner",
                                  "polar_uniform", "polar_arbitrary"])
def test_transform_fed_jax_noise_matches_sample_jax(name):
    jd = _distributions(JK, jpkg.nuclear_map)[name]
    td = _distributions(TK, tpkg.nuclear_map)[name]
    key = jax.random.PRNGKey(17)
    shape = (8192,)
    ref = np.asarray(jd.sample_jax(key, shape))
    got = td.transform(*map(_t, jax_noise_for(td.NOISE, key, shape))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_breit_wigner_table_matches_bit_for_bit():
    jd = _distributions(JK, jpkg.nuclear_map)["breit_wigner"]
    td = _distributions(TK, tpkg.nuclear_map)["breit_wigner"]
    assert np.array_equal(jd._cdf, td._cdf) and np.array_equal(jd._x, td._x)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    assert [jd.sample(rj) for _ in range(3)] == [td.sample(rt) for _ in range(3)]


def test_polar_arbitrary_rejects_probabilities_not_summing_to_one():
    msgs = []
    for K in (JK, TK):
        with pytest.raises(ValueError) as err:
            K.PolarArbitrary(np.array([0.0, 1.0]), np.array([0.3, 0.3]), 1.0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------- the resampling loop


def jax_draw_keys(key, limit: int) -> list:
    """The keys of _run_batch_impl's draws (pipeline.py:300-333): split(key)
    gives k0, k1; the first draw uses k1, each later one split of the
    carried key."""
    k0, k1 = jax.random.split(key)
    keys = [k1]
    carried = k0
    for _ in range(limit - 1):
        carried, sub = jax.random.split(carried)
        keys.append(sub)
    return keys


def feed_jax_noise(tpipe, jpipe, key, n: int):
    """Replace the port's draws with the JAX package's (``_sample``'s
    split of each draw key, pipeline.py:208-258). Returns the draw keys."""
    keys = jax_draw_keys(key, tpipe.event_sample_limit)
    n_keys = 6 + 3 * len(jpipe.decays)

    def draw_noise(draw, seed, event_start, n_, device):
        assert n_ == n
        sub = jax.random.split(keys[draw], n_keys)
        return [None if kind is None else tuple(
            _t(a) for a in jax_noise_for(kind, sub[j], (n,)))
            for j, kind in enumerate(tpipe._noise_kinds)]

    tpipe._draw_noise = draw_noise
    return keys


@pytest.mark.parametrize("case", ["chain", "target", "resample"])
def test_run_batch_fed_jax_noise_matches_jax(case):
    """The masked resampling loop fed the JAX draws against _run_batch_jit:
    accepted lanes and the draw that accepted each exact, momenta within
    1e-9 MeV, vertices within 1e-12 m."""
    n = 256
    jpipe = build(case, False, event_sample_limit=64)
    tpipe = build(case, True, event_sample_limit=64)
    key = jax.random.PRNGKey(23)
    keys = feed_jax_noise(tpipe, jpipe, key, n)
    jv, jm, jacc = map(np.asarray, jpipe._run_batch_jit(key, n))
    got = tpipe.sample_events(n, seed=0)

    allowed = jax.jit(lambda k: jpipe._compute_chain(jpipe._sample(k, n), n)[1])
    ref_at = np.full(n, -1)
    draws = 0
    while draws < jpipe.event_sample_limit and (ref_at < 0).any():
        ok = np.asarray(allowed(keys[draws]))
        ref_at[(ref_at < 0) & ok] = draws
        draws += 1
    assert jacc.all()
    if case == "resample":
        assert draws > 5
    np.testing.assert_array_equal(got.accepted.numpy(), jacc)
    np.testing.assert_array_equal(got.accepted_at.numpy(), ref_at)
    assert got.draws == draws
    _assert_vectors(got.momenta, jm)
    _assert_vectors(got.vertices, jv, atol=VERTEX_ATOL)


def _chain_errors(K, nm):
    d = nm.get_data
    rxn = lambda: K.Reaction(d(5, 10), d(2, 3), d(2, 4))  # noqa: E731
    dec = lambda p, r: K.Decay(d(*p), d(*r))  # noqa: E731
    g = K.ExcitationGaussian
    pu = lambda: K.PolarUniform(0.0, np.pi)  # noqa: E731
    return {
        "empty": ([], [], [], 24.0),
        "excitations_length": ([rxn(), dec((5, 9), (2, 4))], [g(16.8, 0.2)],
                               [pu(), pu()], 24.0),
        "polar_length": ([rxn(), dec((5, 9), (2, 4))],
                         [g(16.8, 0.2), g(0.0, 0.0)], [pu()], 24.0),
        "first_not_reaction": ([dec((5, 9), (2, 4)), rxn()],
                               [g(16.8, 0.2), g(0.0, 0.0)], [pu(), pu()], 24.0),
        "later_not_decay": ([rxn(), rxn()], [g(16.8, 0.2), g(0.0, 0.0)],
                            [pu(), pu()], 24.0),
        "broken_reaction_link": ([rxn(), dec((4, 8), (2, 4))],
                                 [g(16.8, 0.2), g(0.0, 0.0)], [pu(), pu()],
                                 24.0),
        "broken_decay_link": ([rxn(), dec((5, 9), (2, 4)), dec((3, 6), (2, 4))],
                              [g(16.8, 0.2), g(0.0, 0.0), g(0.0, 0.0)],
                              [pu(), pu(), pu()], 24.0),
        "sample_limit": ([rxn()], [g(16.8, 0.2)], [pu()], 2.0),
    }


@pytest.mark.parametrize("case", ["empty", "excitations_length",
                                  "polar_length", "first_not_reaction",
                                  "later_not_decay", "broken_reaction_link",
                                  "broken_decay_link", "sample_limit"])
def test_pipeline_errors_match_jax(case):
    """Every chain-validation error of pipeline.py:136-176 and the sample
    limit (beam 2 MeV, Ex 16.8, limit 50): a PipelineError with the JAX
    package's message."""
    msgs = []
    for port in (False, True):
        K, nm, _, extra = _side(port)
        args = _chain_errors(K, nm)[case]
        with pytest.raises(K.PipelineError) as err:
            pipe = K.KinematicsPipeline(*args, event_sample_limit=50, **extra)
            pipe.run()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    if case == "sample_limit":
        assert msgs[1].startswith("Reached Sampling Limit (50 samples) for 1 ")


def test_host_api_matches_jax():
    for case in ("chain", "target", "resample"):
        j, t = build(case, False), build(case, True)
        assert str(j) == str(t)
        assert np.array_equal(j.get_proton_numbers(), t.get_proton_numbers())
        assert np.array_equal(j.get_mass_numbers(), t.get_mass_numbers())
        assert j.n_nuclei == t.n_nuclei
        for e, ex in ((24.0, [16.8, 0.0, 0.0]), (2.0, [16.8, 0.0, 0.0]),
                      (16.0, [30.0]), (120.0, [0.0])):
            ex = ex[:len(t.excitations)] + [0.0] * (len(t.excitations) - len(ex))
            assert j.check_excitations_allowed(e, ex) == \
                t.check_excitations_allowed(e, ex)
    d = tpkg.nuclear_map.get_data
    assert str(TK.Decay(d(5, 9), d(2, 4))) == str(
        JK.Decay(jpkg.nuclear_map.get_data(5, 9), jpkg.nuclear_map.get_data(2, 4)))


# ------------------------------------------------ the port's own sampler


def test_excitation_statistics():
    """tests/test_kinematics.py:202-220 on the port's Philox draws."""
    _, momenta = build("gauss", True).run_batch(4096, seed=3)
    resid = momenta[:, 3]
    m_inv = np.sqrt(resid[:, 3] ** 2 - (resid[:, :3] ** 2).sum(axis=-1))
    ex = m_inv - tpkg.nuclear_map.get_data(6, 13).mass
    assert abs(ex.mean() - 3.089) < 0.02
    assert abs(ex.std() - 0.2 / 2.355) < 0.01


def test_polar_uniform_statistics():
    """tests/test_kinematics.py:223-250 on the port's Philox draws."""
    pipe = build("gauss", True)
    pipe.excitations = [TK.ExcitationGaussian(0.0, 0.0)]
    _, momenta = pipe.run_batch(8192, seed=5)
    parent = momenta[:, 0] + momenta[:, 1]
    beta = parent[:, 2] / parent[:, 3]
    gamma = 1.0 / np.sqrt(1.0 - beta**2)
    ej = momenta[:, 2]
    pz_cm = gamma * (ej[:, 2] - beta * ej[:, 3])
    cos_th = pz_cm / np.sqrt(ej[:, 0] ** 2 + ej[:, 1] ** 2 + pz_cm**2)
    assert abs(cos_th.mean()) < 0.02
    assert abs((cos_th**2).mean() - 1.0 / 3.0) < 0.01


def test_vertex_and_beam_energy_loss_statistics():
    """tests/test_kinematics.py:253-309 on the port's Philox draws: rho
    |N(0, sigma)|, theta uniform, z uniform in z_range, and the projectile's
    kinetic energy at the vertex the beam energy less get_energy_loss(z)."""
    pipe = build("target", True)
    n = 16384
    z_lo, z_hi, rho_sigma, beam = 0.2, 0.8, 0.007, 120.0
    vertices, momenta = pipe.run_batch(n, seed=11)
    z = vertices[:, 2]
    assert z.min() >= z_lo and z.max() <= z_hi
    assert np.mean(z) == pytest.approx((z_lo + z_hi) / 2, abs=0.005)
    assert np.var(z) == pytest.approx((z_hi - z_lo) ** 2 / 12, rel=0.05)
    rho = np.hypot(vertices[:, 0], vertices[:, 1])
    assert np.mean(rho) == pytest.approx(rho_sigma * np.sqrt(2 / np.pi), rel=0.03)
    assert np.mean(rho**2) == pytest.approx(rho_sigma**2, rel=0.05)
    assert abs(np.mean(vertices[:, 0])) < 3 * rho_sigma / np.sqrt(n)
    assert abs(np.mean(vertices[:, 1])) < 3 * rho_sigma / np.sqrt(n)
    c12 = tpkg.nuclear_map.get_data(6, 12)
    ke = momenta[:, 1, 3] - c12.mass
    gas = pipe.target_material.material
    np.testing.assert_allclose(ke, beam - gas.get_energy_loss(c12, beam, z),
                               rtol=1e-6)
    order = np.argsort(z)
    means = [b.mean() for b in np.array_split(ke[order], 16)]
    assert np.all(ke < beam) and all(a > b for a, b in zip(means, means[1:]))


def _ejectile(momenta: np.ndarray, mass: float):
    ej = momenta[:, 2]
    p = np.sqrt((ej[:, :3] ** 2).sum(axis=-1))
    return {"ke": ej[:, 3] - mass, "polar": np.arccos(ej[:, 2] / p)}


@pytest.mark.parametrize("case", ["target", "resample"])
def test_ejectile_matches_jax_sampler_by_distribution(case):
    """Two-sample KS tests of the ejectile's lab kinetic energy and polar
    angle, the port's Philox draws against the JAX sampler (fixed seeds,
    8,192 events each): p > 1e-3."""
    n = 8192
    _, jm = build(case, False).run_batch(n, key=jax.random.PRNGKey(31))
    _, tm = build(case, True).run_batch(n, seed=31)
    mass = tpkg.nuclear_map.get_data(1, 1).mass
    j, t = _ejectile(np.asarray(jm), mass), _ejectile(tm, mass)
    for q in ("ke", "polar"):
        assert ks_2samp(j[q], t[q]).pvalue > 1e-3, q


def test_chain_conserves_momentum():
    """tests/test_kinematics.py:78-93 on the port's draws: initial = target
    + projectile, final = ejectile + the last decays' products, atol 1e-8;
    every outgoing particle on-shell or above."""
    _, momenta = build("chain", True).run_batch(256, seed=7)
    assert momenta.shape == (256, 8, 4)
    initial = momenta[:, 0] + momenta[:, 1]
    final = momenta[:, 2] + momenta[:, 4] + momenta[:, 6] + momenta[:, 7]
    np.testing.assert_allclose(initial, final, rtol=0, atol=1e-8)
    assert np.all(momenta[:, :, 3] ** 2 - (momenta[:, :, :3] ** 2).sum(-1) > 0)


@pytest.mark.parametrize("case", ["resample", "target"])
def test_events_do_not_depend_on_the_batch_grid(case):
    """Events [0, 512) in one batch equal two batches [0, 256) and [256,
    512) bit for bit (draws keyed per event); another seed differs."""
    pipe = build(case, True)
    whole = pipe.sample_events(512, seed=41)
    parts = [pipe.sample_events(256, seed=41, event_start=s) for s in (0, 256)]
    assert whole.accepted.all()
    for f in ("vertices", "momenta", "accepted", "accepted_at"):
        assert torch.equal(getattr(whole, f),
                           torch.cat([getattr(p, f) for p in parts])), f
    if case == "resample":
        assert whole.draws > 1
    other = pipe.sample_events(512, seed=42)
    assert not torch.equal(whole.momenta, other.momenta)


def test_draws_are_uniform_and_normal():
    """The Philox uniforms lie in [0, 1) with 53-bit resolution and the
    normals are standard (moments of 65,536 draws)."""
    pipe = build("target", True)
    noise = pipe._draw_noise(3, 9, 1000, 65536, torch.device("cpu"))
    z = noise[0][0].numpy()
    u = noise[1][0].numpy()
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.var() - 1 / 12) < 0.002
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    assert np.isfinite(z).all()
    assert not np.array_equal(u, noise[2][0].numpy())


# ------------------------------------------------------- the file boundary


@pytest.mark.parametrize("schema", ["columnar", "reference"])
def test_kinematics_files_cross_the_package_boundary(schema, tmp_path):
    """The port's run_kinematics_pipeline writes both schemas: the JAX
    package's reader reads exactly the events the port sampled (in batches
    of 100, the tail batch short), and the port's reader reads the JAX
    pipeline's file as the JAX reader does. The manifest says stage
    "kinematics"."""
    n = 256
    tpipe = build("target", True)
    path = tmp_path / "port.h5"
    TK.run_kinematics_pipeline(tpipe, n, path, batch_size=100, seed=13,
                               schema=schema, show_progress=False,
                               device="cpu")
    ref_v, ref_m = tpipe.run_batch(n, seed=13)
    reader = JReader(path)
    v, m = reader.read_range(0, n)
    assert reader.n_events == n
    assert np.array_equal(reader.proton_numbers, tpipe.get_proton_numbers())
    assert np.array_equal(reader.mass_numbers, tpipe.get_mass_numbers())
    reader.close()
    assert np.array_equal(v, ref_v) and np.array_equal(m, ref_m)
    manifest = json.loads(path.with_suffix(".h5.run.json").read_text())
    assert manifest["stage"] == "kinematics"
    assert manifest["backend"]["platform"] == "cpu"
    assert manifest["event_range"] == [0, n]

    jpath = tmp_path / "jax.h5"
    JK.run_kinematics_pipeline(build("chain", False), 64, jpath, batch_size=64,
                               seed=3, schema=schema, show_progress=False)
    a, b = JReader(jpath), TReader(jpath)
    for x, y in zip(a.read_range(0, 64), b.read_range(0, 64)):
        assert np.array_equal(x, y)
    assert np.array_equal(a.mass_numbers, b.mass_numbers)
    a.close()
    b.close()


def test_run_kinematics_takes_any_writer_and_closes_it():
    """run_kinematics hands each batch to the writer (the same events for
    any batch size) and closes it, also when the sample limit raises."""

    class Writer:
        def __init__(self):
            self.batches, self.closed = [], False

        def write_batch(self, vertices, momenta):
            self.batches.append((vertices, momenta))

        def close(self):
            self.closed = True

    pipe = build("resample", True)
    w1, w2 = Writer(), Writer()
    s1 = TK.run_kinematics(pipe, 300, w1, batch_size=300, seed=5,
                           show_progress=False, device="cpu")
    s2 = TK.run_kinematics(pipe, 300, w2, batch_size=128, seed=5,
                           show_progress=False, device="cpu")
    assert w1.closed and w2.closed
    assert [len(v) for v, _ in w2.batches] == [128, 128, 44]
    assert s1["events"] == s2["events"] == 300 and len(s2["draws"]) == 3
    assert np.array_equal(w1.batches[0][1],
                          np.concatenate([m for _, m in w2.batches]))
    banned = TK.KinematicsPipeline(*_chain_errors(TK, tpkg.nuclear_map)[
        "sample_limit"], event_sample_limit=5, device="cpu")
    w3 = Writer()
    with pytest.raises(TK.PipelineError, match="Reached Sampling Limit"):
        TK.run_kinematics(banned, 10, w3, seed=1, show_progress=False,
                          device="cpu")
    assert w3.closed and not w3.batches
