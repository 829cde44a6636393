"""repro_torch kernels: the plain PyTorch versions against the JAX package.

Each kernel of the port's slice (gram, row_gram, probe_sweep, commit_sweep)
has a plain PyTorch version that the ops wrappers run for CPU tensors.  Here
those are held, on the same numpy inputs, against

  * the JAX Pallas kernels in interpret mode, at rtol 2e-4 and atol
    2e-4 * sqrt(n) (the precedent of test_sweep_kernels.py), and
  * the JAX `ref.py` functions, both sides fp32: 1e-5 relative, normwise
    (max |torch - jax| <= 1e-5 * max |jax|), since entries of a Gram or a
    gradient may sit near zero;

and the native-dtype twins (probe_etas_closed, probe_sweep_ref,
commit_sweep_ref) in float64 at 1e-12.  The CUDA kernels themselves run
only on the card: tests/test_torch_cuda.py holds them against these plain
versions there.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram import ops as jgram_ops
from repro.kernels.gram import ref as jgram_ref
from repro.kernels.sweep import ops as jsweep_ops
from repro.kernels.sweep import ref as jsweep_ref
from repro_torch.kernels import _build
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.sweep import ops as sweep_ops
from repro_torch.kernels.sweep import ref as sweep_ref

SHAPES = [(5, 600), (37, 1000), (130, 300)]


def _scene(d, n, seed=0, dtype=np.float32):
    """Residual rows, an SPD m_inv with s = m_inv 1, eta = sum s, a small
    row delta and a K=16 step schedule, all numpy."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((d, n))
    m = rng.standard_normal((d, 2 * d))
    m_inv = m @ m.T / (2 * d) + np.eye(d)
    m_inv = 0.5 * (m_inv + m_inv.T)
    s = m_inv.sum(axis=1)
    delta = 0.05 * rng.standard_normal(n)
    steps = math.sqrt(n) * 0.5 ** np.arange(16)
    out = dict(r=r, m_inv=m_inv, s=s, eta=s.sum(), delta=delta, steps=steps,
               v=rng.standard_normal(n))
    return {k: np.asarray(v, dtype) for k, v in out.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_normwise(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.max(np.abs(want)), 1e-30)
    err = np.max(np.abs(got - want))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


# ------------------------------------------------------------ gram / row_gram


@pytest.mark.parametrize("d,n", SHAPES)
def test_gram_plain_matches_jax(d, n):
    sc = _scene(d, n)
    got = gram_ops.gram(_t(sc["r"])).numpy()
    pallas = np.asarray(jgram_ops.gram(jnp.asarray(sc["r"]), use_pallas=True,
                                       interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4 * n ** 0.5)
    _close_normwise(got, jgram_ref.gram_ref(jnp.asarray(sc["r"])), 1e-5, "gram")
    assert got.dtype == np.float32


@pytest.mark.parametrize("d,n", SHAPES)
def test_row_gram_plain_matches_jax(d, n):
    sc = _scene(d, n)
    got = gram_ops.row_gram(_t(sc["v"]), _t(sc["r"])).numpy()
    pallas = np.asarray(jgram_ops.row_gram(jnp.asarray(sc["v"]),
                                           jnp.asarray(sc["r"]),
                                           use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4 * n ** 0.5)
    _close_normwise(got, jgram_ref.row_gram_ref(jnp.asarray(sc["v"]),
                                                jnp.asarray(sc["r"])),
                    1e-5, "row_gram")


def test_gram_plain_reads_f64_as_fp32():
    """The fp32 contract: a float64 residual is read as fp32 and summed in
    fp32, exactly as the JAX kernel's `astype(float32)`."""
    sc = _scene(6, 200, dtype=np.float64)
    got = gram_ops.gram(_t(sc["r"]))
    assert got.dtype == torch.float32
    r32 = sc["r"].astype(np.float32)
    _close_normwise(got.numpy(), r32 @ r32.T, 1e-6, "gram f64 input")


# ------------------------------------------------------------------- probe


@pytest.mark.parametrize("schedule", ["main", "small"])
@pytest.mark.parametrize("d,n", SHAPES)
def test_probe_plain_matches_jax(d, n, schedule):
    """`main` is the engine's schedule, sqrt(n) * 0.5^k; `small` the
    0.5^(1..8) of test_sweep_kernels' exact-schedule test.  At the main
    schedule's large steps the closed form's pivot det cancels, and two fp32
    evaluations of the etas agree only to ~4e-5 (measured at D=130, both
    against the JAX oracle and the JAX kernel): there the etas are held at
    the kernel tolerance, the three products at 1e-5."""
    sc = _scene(d, n, seed=d + n)
    if schedule == "small":
        sc["steps"] = (0.5 ** np.arange(1, 9)).astype(np.float32)
    i = d // 2
    got = sweep_ops.probe_sweep(_t(sc["r"]), _t(sc["m_inv"]), _t(sc["s"]),
                                _t(sc["eta"]), i, _t(sc["steps"]))
    jargs = [jnp.asarray(sc[k]) for k in ("r", "m_inv", "s", "eta")]
    pallas = jsweep_ops.probe_sweep(*jargs, i, jnp.asarray(sc["steps"]),
                                    use_pallas=True, interpret=True)
    ref = jsweep_ref.probe_sweep_ref(*jargs, i, jnp.asarray(sc["steps"]))
    for g, p, r, name in zip(got, pallas, ref, ("etas", "cross", "p", "gnorm")):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=2e-4,
                                   atol=2e-4 * n ** 0.5, err_msg=name)
        tol = 2e-4 if (name == "etas" and schedule == "main") else 1e-5
        _close_normwise(g.numpy(), r, tol, name)


# ------------------------------------------------------------------ commit


@pytest.mark.parametrize("regime", ["accept", "reject", "eta0"])
@pytest.mark.parametrize("d,n", SHAPES[:2])
def test_commit_plain_matches_jax(d, n, regime):
    sc = _scene(d, n, seed=3 * d + n)
    i = d // 3
    thr = {"accept": -np.inf, "reject": np.inf, "eta0": sc["eta"]}[regime]
    thr = np.float32(thr)
    got = sweep_ops.commit_sweep(_t(sc["r"]), _t(sc["m_inv"]), _t(sc["s"]),
                                 _t(sc["eta"]), i, _t(sc["delta"]), 1.0, 0.0,
                                 _t(thr), True)
    jargs = [jnp.asarray(sc[k]) for k in ("r", "m_inv", "s", "eta")]
    jd = jnp.asarray(sc["delta"])
    one, zero = jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)
    pallas = jsweep_ops.commit_sweep(*jargs, i, jd, one, zero, jnp.asarray(thr),
                                     jnp.bool_(True), use_pallas=True,
                                     interpret=True)
    ref = jsweep_ref.commit_sweep_ref(*jargs, i, jd, one, zero,
                                      jnp.asarray(thr), jnp.bool_(True))
    assert bool(got[3]) == bool(pallas[3]) == bool(ref[3])
    if regime != "eta0":
        assert bool(got[3]) == (regime == "accept")
    for k, name in ((0, "m_inv"), (1, "s"), (2, "u_eff"), (4, "obj_post")):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(pallas[k]),
                                   rtol=2e-4, atol=2e-4 * n ** 0.5, err_msg=name)
        _close_normwise(got[k].numpy(), ref[k], 1e-5, name)


def test_commit_reject_is_bitwise_noop():
    sc = _scene(9, 400, seed=11)
    m_inv, s = _t(sc["m_inv"]), _t(sc["s"])
    out = sweep_ops.commit_sweep(_t(sc["r"]), m_inv, s, _t(sc["eta"]), 4,
                                 _t(sc["delta"]), 1.0, 0.0, float("inf"), True)
    assert not bool(out[3])
    assert torch.equal(out[0], m_inv) and torch.equal(out[1], s)
    assert not bool(out[2].any())
    # the transport gate rejects just the same
    out = sweep_ops.commit_sweep(_t(sc["r"]), m_inv, s, _t(sc["eta"]), 4,
                                 _t(sc["delta"]), 1.0, 0.0, float("-inf"), False)
    assert not bool(out[3]) and torch.equal(out[0], m_inv)


# ------------------------------------------------- native-dtype twins (f64)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _close(got, want, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol * max(np.max(np.abs(np.asarray(want))), 1e-300))


@pytest.mark.parametrize("c1h", [0.0, -0.3])
def test_probe_etas_closed_f64(x64, c1h):
    sc = _scene(11, 300, seed=5, dtype=np.float64)
    p = sc["r"][:, :1][:, 0] * 1e-2
    got = sweep_ref.probe_etas_closed(_t(sc["m_inv"]), _t(sc["s"]), _t(sc["eta"]),
                                      3, _t(sc["steps"]), _t(p), c1h, 0.07)
    want = jsweep_ref.probe_etas_closed(
        jnp.asarray(sc["m_inv"]), jnp.asarray(sc["s"]), jnp.asarray(sc["eta"]),
        3, jnp.asarray(sc["steps"]), jnp.asarray(p), c1h, 0.07)
    _close(got.numpy(), want)


def test_probe_sweep_ref_f64(x64):
    sc = _scene(12, 500, seed=6, dtype=np.float64)
    got = sweep_ref.probe_sweep_ref(*(_t(sc[k]) for k in ("r", "m_inv", "s", "eta")),
                                    5, _t(sc["steps"]))
    want = jsweep_ref.probe_sweep_ref(*(jnp.asarray(sc[k]) for k in
                                        ("r", "m_inv", "s", "eta")),
                                      5, jnp.asarray(sc["steps"]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g.numpy(), w)


@pytest.mark.parametrize("thr", [-np.inf, np.inf])
def test_commit_sweep_ref_f64(x64, thr):
    sc = _scene(12, 500, seed=7, dtype=np.float64)
    targs = [_t(sc[k]) for k in ("r", "m_inv", "s", "eta")]
    jargs = [jnp.asarray(sc[k]) for k in ("r", "m_inv", "s", "eta")]
    got = sweep_ref.commit_sweep_ref(*targs, 2, _t(sc["delta"]), 1.0, 0.0,
                                     thr, True)
    want = jsweep_ref.commit_sweep_ref(*jargs, 2, jnp.asarray(sc["delta"]),
                                       1.0, 0.0, thr, True)
    assert bool(got[3]) == bool(want[3])
    for k in (0, 1, 2, 4):
        _close(got[k].numpy(), want[k])


# ------------------------------------------------------ wrapper plumbing


GEOMETRY_CASES = [(1, 7), (5, 600), (5, 2000), (64, 3000), (100, 20001),
                  (100, 262144), (120, 2002), (127, 131), (128, 5000),
                  (129, 100), (130, 5000), (300, 20000)]


@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("d,n", GEOMETRY_CASES)
def test_gram_geometry_covers_n(d, n, blocks_per_sm):
    """The N-chunks of gram cover N exactly with no empty chunk, each a
    whole number of the block's steps (32 kg instances), and the grid
    (tile pairs x chunks) is at most one wave of 132 SMs; the block fits
    the card and its shared memory holds the ring and the groups' sums."""
    threads, kg, smem = gram_ops.gram_block(d)
    chunk, splits = gram_ops.gram_geometry(d, n, 132, blocks_per_sm)
    step = 32 * kg
    assert chunk % step == 0 and chunk >= step
    assert (splits - 1) * chunk < n <= splits * chunk
    pairs = gram_ops.gram_pairs(d)
    assert pairs * splits <= max(pairs, 132 * blocks_per_sm)
    assert threads % (32 * kg) == 0 and threads <= 384 and 1 <= kg <= 4
    gt, tiles = threads // kg, -(-d // 128)
    if tiles == 1:
        g = -(-d // 8)
        assert g * (g + 1) // 2 <= gt < g * (g + 1) // 2 + 32   # triangle only
        groups = g
    else:
        assert gt == 256
        groups = 32
    ring = 3 * groups * (8 * step + 4) * 4        # 8-row groups padded by 16 B
    assert smem == max(ring, (kg - 1) * 64 * gt * 4) and smem <= 232448


def test_gram_geometry_fills_one_wave_at_the_deployment_shape():
    """D=100, N=262144: one diagonal tile, 91 micro-tiles (96 threads) in
    each of 4 groups, and 128 chunks of 2048 on the 132 SMs (one block of
    384 threads each): 97% of a wave."""
    assert gram_ops.gram_block(100) == (384, 4, 3 * 13 * (8 * 128 + 4) * 4)
    assert gram_ops.gram_pairs(100) == 1
    assert gram_ops.gram_geometry(100, 262144, 132, 1) == (2048, 128)


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("n", [7, 128, 600, 2000, 20001, 262144, 1 << 20])
def test_row_gram_geometry_covers_n(n, blocks_per_sm):
    """row_gram's strips: a multiple of 128 columns, at most 1024, covering
    N exactly with no empty strip, in the fewest whole waves of 132 SMs
    that 1024-column strips allow; its scratch pads each row to 4 floats."""
    strip, blocks = gram_ops.row_gram_geometry(n, 132, blocks_per_sm)
    assert strip % 128 == 0 and 128 <= strip <= 1024
    assert (blocks - 1) * strip < n <= blocks * strip
    slots = 132 * blocks_per_sm
    waves = -(-blocks // slots)
    assert waves == max(1, -(-(-(-n // 1024)) // slots))
    assert gram_ops.row_gram_partial_floats(100, blocks) == 100 * (-(-blocks // 4) * 4)
    if n == 262144 and blocks_per_sm == 2:
        assert (strip, blocks) == (1024, 256)           # 97% of one wave


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("d,n", GEOMETRY_CASES)
def test_probe_geometry_covers_n(d, n, blocks_per_sm, batch):
    """The probe's chunks cover N with no empty chunk; only the grid's
    trial entry depends on the batch; the register route (D <= 128) holds
    at most 16 rows a warp in whole 128-column strips, in at most one wave
    of 132 SMs, and its partials are padded to 4 for 16-byte loads; above
    D = 128 the shared-memory route keeps probe_block_n's tile."""
    geo = sweep_ops.probe_geometry(d, n, batch, 132, blocks_per_sm)
    one = sweep_ops.probe_geometry(d, n, 1, 132, blocks_per_sm)
    assert geo._replace(grid=None) == one._replace(grid=None)
    assert geo.grid == (geo.blocks, batch)
    assert (geo.blocks - 1) * geo.chunk < n <= geo.blocks * geo.chunk
    assert geo.route == sweep_ops.probe_route(d)
    assert geo.route == ("registers" if d <= 128 else "shared")
    if geo.route == "registers":
        rpw = sweep_ops.probe_rows_per_warp(d)
        assert 1 <= rpw <= 16 and 8 * rpw >= d > 8 * (rpw - 1)
        assert geo.chunk % 128 == 0
        assert geo.blocks <= 132 * blocks_per_sm
        strips = -(-n // 128)
        assert -(-strips // (geo.chunk // 128)) == geo.blocks
        padded = -(-geo.blocks // 4) * 4
        assert (geo.part_p, geo.part_gg) == (d * padded, padded)
    else:
        assert geo.chunk == sweep_ops.probe_block_n(d)
        assert (geo.part_p, geo.part_gg) == (geo.blocks * d, geo.blocks)


def test_probe_route_switches_above_128_rows():
    """The route switches where a warp would need more than 16 rows of
    float4 registers; at the deployment shape one wave of 256 chunks of 1024
    columns (two blocks on each of 132 SMs)."""
    assert sweep_ops.PROBE_REGISTER_MAX_D == 128
    assert [sweep_ops.probe_route(d) for d in (1, 100, 128, 129, 300)] == [
        "registers", "registers", "registers", "shared", "shared"]
    assert sweep_ops.probe_rows_per_warp(100) == 13
    geo = sweep_ops.probe_geometry(100, 262144, 8, 132, 2)
    assert (geo.chunk, geo.blocks, geo.grid) == (1024, 256, (256, 8))


def test_probe_block_fits_shared_memory():
    for d in (1, 5, 100, 300, 1000, 1500):
        bn = sweep_ops.probe_block_n(d)
        assert bn % 32 == 0 and 32 <= bn <= 256
        assert (d * bn + bn + d + 33) * 4 <= 232448
    with pytest.raises(ValueError):
        sweep_ops.probe_block_n(5000)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("d,n", GEOMETRY_CASES)
def test_commit_geometry_follows_row_gram(d, n, batch):
    """The commit streams row_gram's strips, one block a strip; its scratch
    holds d + 1 rows (w and <delta, delta>) of strips padded to 4; only the
    grid's trial entry depends on the batch."""
    geo = sweep_ops.commit_geometry(d, n, batch, 132, 2)
    strip, blocks = gram_ops.row_gram_geometry(n, 132, 2)
    assert (geo.strip, geo.blocks, geo.grid) == (strip, blocks, (blocks, batch))
    assert geo.part == (d + 1) * (-(-blocks // 4) * 4)
    assert geo._replace(grid=None) == sweep_ops.commit_geometry(d, n, 1, 132, 2)._replace(
        grid=None)


def test_commit_geometry_hand_worked():
    """N = 262144 on 132 SMs at 2 blocks each: 256 strips of 1024 columns
    (97% of one wave); N = 20001: 157 strips of 128 (one wave needs only 20
    of 1024); a batch of 8 changes the grid's second entry only."""
    g = sweep_ops.commit_geometry(100, 262144, 1, 132, 2)
    assert g == (1024, 256, (256, 1), 101 * 256)
    g = sweep_ops.commit_geometry(100, 20001, 1, 132, 2)
    assert g == (128, 157, (157, 1), 101 * 160)
    assert sweep_ops.commit_geometry(100, 262144, 8, 132, 2) == (1024, 256, (256, 8),
                                                                  101 * 256)
    assert not hasattr(sweep_ops, "COMMIT_BN")


@pytest.mark.parametrize("thr", [-np.inf, np.inf, "eta0"])
def test_commit_takes_numbers_and_tensors_alike(thr):
    """threshold and can_tx as Python numbers (the kernel takes them by
    value) and as tensors (the kernel reads them) give the same result;
    accept is a torch.bool, 0-d for one trial and (B,) for a batch."""
    sc = _scene(6, 300, seed=21)
    thr = float(sc["eta"]) if thr == "eta0" else float(thr)
    args = (_t(sc["r"]), _t(sc["m_inv"]), _t(sc["s"]), _t(sc["eta"]), 2, _t(sc["delta"]),
            1.0, 0.0)
    for can in (True, False):
        by_value = sweep_ops.commit_sweep(*args, thr, can)
        as_tensors = sweep_ops.commit_sweep(*args, torch.tensor(thr, dtype=torch.float32),
                                            torch.tensor(can))
        assert by_value[3].dtype == torch.bool and by_value[3].shape == ()
        assert all(map(torch.equal, by_value, as_tensors))
    b = 3
    bargs = tuple(torch.stack([a] * b) if isinstance(a, torch.Tensor) else a for a in args)
    batched = sweep_ops.commit_sweep(*bargs, thr, True)
    assert batched[3].dtype == torch.bool and batched[3].shape == (b,)
    per_trial = sweep_ops.commit_sweep(*bargs, torch.full((b,), thr), torch.ones(b))
    assert all(map(torch.equal, batched, per_trial))


def test_wrappers_raise_off_cpu_and_cuda():
    r = torch.empty((4, 10), device="meta")
    with pytest.raises(ValueError):
        gram_ops.gram(r)
    with pytest.raises(ValueError):
        gram_ops.row_gram(torch.empty((10,), device="meta"), r)


def test_cpu_path_never_counts_launches():
    _build.reset_launches()
    sc = _scene(4, 50)
    gram_ops.gram(_t(sc["r"]))
    gram_ops.row_gram(_t(sc["v"]), _t(sc["r"]))
    assert all(v == 0 for v in _build.LAUNCHES.values())
