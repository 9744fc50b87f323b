"""The batched subgrid build and the two lattice scorers against the float64
oracle, on subgrids that overhang the full grid and with far-sentinel
query lanes (the matcher's padded lanes)."""
import numpy as np
import jax.numpy as jnp
import pytest

from yag_slam_tpu.matching import correlation as C

from oracle import oracle_build_grid, oracle_kernel, oracle_score_lattice

G, S, RES = 451, 512, 0.01
FAR = 1e9


def _lattice(stride):
    xy_res = RES * stride
    spec = C.LatticeSpec.from_search(0.0, 0.0, 0.0, 12.5 * xy_res, xy_res,
                                     0.1745, 0.0349)
    return spec, dict(xy_size=12.5 * xy_res, xy_res=xy_res, ang_size=0.1745,
                      ang_res=0.0349)


def _jobs():
    """Two jobs: a subgrid at the origin (S > G: it overhangs the high
    edge on both axes) and one offset so that sox + S > G."""
    rng = np.random.default_rng(11)
    sox = np.array([0, 97], dtype=np.int32)
    soy = np.array([0, 41], dtype=np.int32)
    full = []
    for j in range(2):
        q = np.floor(rng.uniform(0, 100, (G, G)))
        # the subgrid holds every nonzero cell (the matcher's premise)
        q[:soy[j], :] = 0.0
        q[:, :sox[j]] = 0.0
        full.append(q)
    # past the grid's high edge the subgrid holds what smear spreads
    # there: nonzero cells the reference never reads
    sub = np.floor(rng.uniform(0, 100, (2, S, S)))
    for j in range(2):
        blk = full[j][soy[j]:soy[j] + S, sox[j]:sox[j] + S]
        sub[j, :blk.shape[0], :blk.shape[1]] = blk
    return full, sub, sox, soy


@pytest.mark.parametrize("penalize", [True, False])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_scorers_match_oracle(stride, penalize):
    """Element gathers, window gathers and the oracle agree cell for cell,
    with windows that overhang every subgrid and grid edge and with
    far-sentinel lanes beyond each job's point count."""
    spec, lat = _lattice(stride)
    full, sub, sox, soy = _jobs()
    rng = np.random.default_rng(stride)
    P = 96
    n = np.array([P - 8, P - 23])
    px = rng.uniform(-2.5, 2.5, (2, P))
    py = rng.uniform(-2.5, 2.5, (2, P))
    for j in range(2):
        px[j, n[j]:] = FAR
        py[j, n[j]:] = FAR
    # search centers near the low corner and past the high edge
    cx = np.array([0.3, 4.3])
    cy = np.array([0.2, 4.4])
    ct = np.array([0.0, 0.4])
    ox = oy = np.zeros(2)
    kw = dict(spec=spec, grid_size=G, grid_res=RES, sub_size=S,
              penalize=penalize, dtype=jnp.float64, **lat)
    args = (px, py, n.astype(float), cx, cy, ct, ox, oy, sox, soy)
    out_el, *_ = C.score_lattice_batched(sub, *args, **kw)
    masked = C.mask_past_grid(jnp.asarray(sub), jnp.asarray(sox),
                              jnp.asarray(soy), G)
    out_pt, *_ = C.score_lattice_patch_batched(masked, *args, **kw)
    for j in range(2):
        want, *_ = oracle_score_lattice(
            full[j], px[j, :n[j]], py[j, :n[j]], cx[j], cy[j], ct[j],
            ox[j], oy[j], lat["xy_size"], lat["xy_res"], lat["ang_size"],
            lat["ang_res"], RES, penalize)
        assert want.shape == tuple(spec)
        np.testing.assert_allclose(np.asarray(out_el)[j], want, atol=1e-12)
        np.testing.assert_allclose(np.asarray(out_pt)[j], want, atol=1e-12)
    # the scenario reads past the grid's high edge: unmasked windows differ
    raw, *_ = C.score_lattice_patch_batched(jnp.asarray(sub), *args, **kw)
    assert not np.allclose(np.asarray(raw), np.asarray(out_el))


@pytest.mark.parametrize("sox,soy,Sb", [
    (0, 0, 512),        # S > G: overhangs both high edges
    (180, 40, 384),     # sox + S > G on x only
    (60, 100, 256),     # interior subgrid; points outside it are dropped
])
def test_staged_build_matches_oracle(sox, soy, Sb):
    """Scatter -> halo-only smear -> quantize -> bounds mask equals the
    oracle's full-grid build, sliced at the subgrid, for out-of-grid,
    halo-band, masked-out and far-sentinel points."""
    res, smear = RES, 0.03
    k1 = C.gaussian_kernel_1d(res, smear)
    h = (len(k1) - 1) // 2
    rng = np.random.default_rng(sox + soy)
    B, P = 3, 120
    ox, oy = -0.7, 0.4
    wx = ox + rng.uniform(-0.3, (G + 20) * res, (1, B, P))
    wy = oy + rng.uniform(-0.3, (G + 20) * res, (1, B, P))
    wx[..., -5:] = FAR
    wy[..., -5:] = FAR
    keep = rng.uniform(size=(1, B, P)) > 0.25
    q, cgrid = C.build_quantized_subgrids(
        jnp.asarray(wx), jnp.asarray(wy), jnp.asarray(keep),
        jnp.asarray([ox]), jnp.asarray([oy]), jnp.asarray([sox]),
        jnp.asarray([soy]), G=G, S=Sb, h=h, res=res,
        taps=tuple(float(v) for v in k1), dtype=jnp.float64)
    kept = [(wx[0, b][keep[0, b]], wy[0, b][keep[0, b]]) for b in range(B)]
    ref = np.floor(100.0 * oracle_build_grid(kept, ox, oy, G, res,
                                             oracle_kernel(res, smear)))
    want = np.zeros((Sb, Sb))
    blk = ref[soy:soy + Sb, sox:sox + Sb]
    want[:blk.shape[0], :blk.shape[1]] = blk
    np.testing.assert_array_equal(np.asarray(q)[0], want)
    assert np.asarray(cgrid).shape == (1, Sb, Sb)
    assert want.sum() > 0
