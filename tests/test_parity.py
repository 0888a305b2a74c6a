"""The product scorer against its float64 NumPy reference
(navlab_dpe_sdr_tpu.parity), at shapes that exercise the chunk padding."""

import numpy as np
import jax.numpy as jnp
import pytest

from navlab_dpe_sdr_tpu import parity
from navlab_dpe_sdr_tpu.ops import dpe_real as dr


def _scene(n, c, w, g, seed=11):
    """Peaked correlation-like windows + noise and a grid whose tap
    indices stay inside the window (the regime auto_windows guarantees)."""
    rng = np.random.default_rng(seed)
    lag = np.arange(w) - (w - 1) / 2.0
    win = (1e4 * np.maximum(0.0, 1.0 - np.abs(lag) / 3.0)[None, None, :]
           + np.abs(rng.standard_normal((n, c, w))) * 300.0
           ).astype(np.float32)
    los = rng.standard_normal((n, c, 3))
    los = (los / np.linalg.norm(los, axis=2, keepdims=True)).astype(
        np.float32)
    centers = ((w - 1) / 2.0 + rng.standard_normal((n, c)) * 0.3
               ).astype(np.float32)
    coefs = np.full((n, c), 0.02, np.float32)
    r0 = np.full((n, c), 2.2e7, np.float32)
    span = (w / 2.0 - 3.0) / 0.02 / 3.0
    o3 = (rng.uniform(-1, 1, (g, 3)) * span).astype(np.float32)
    o1 = (rng.uniform(-1, 1, g) * span).astype(np.float32)
    return win, los, centers, coefs, r0, o3, o1


@pytest.mark.parametrize("manifold", ["pos", "vel"])
@pytest.mark.parametrize("l_power", [1, 2])
def test_score_chunk_matches_float64_reference(manifold, l_power):
    """_score_chunk over a grid that does not divide the chunk, against
    the float64 3-tap reference: float32 rounding class, same argmax."""
    win, los, cen, coe, r0, o3, o1 = _scene(n=3, c=8, w=24, g=3000)
    r0 = r0 if manifold == "pos" else None
    got = parity.score_chunks(win, los, cen, coe, r0, o3, o1, l_power,
                              chunk=1024)
    ref, keep = parity.score_reference(win, los, cen, coe, r0, o3, o1,
                                       l_power)
    assert got.shape == ref.shape == (3, 3000)
    assert keep.mean() > 0.5     # 24 (block, channel) indices per point
    assert parity.max_rel(got[:, keep], ref[:, keep]) < 1e-5
    np.testing.assert_array_equal(got[:, keep].argmax(1),
                                  ref[:, keep].argmax(1))


@pytest.mark.parametrize("manifold", ["pos", "vel"])
def test_score_chunk_odd_sizes(manifold):
    """W = 9, C = 5 and a grid of 1001 points in chunks of 256."""
    win, los, cen, coe, r0, o3, o1 = _scene(n=2, c=5, w=9, g=1001, seed=4)
    r0 = r0 if manifold == "pos" else None
    rep = parity.scorer_parity(win, los, cen, coe, r0, o3, o1, chunk=256)
    assert rep["score_max_rel"] < 1e-5, rep
    assert rep["score_argmax_equal"], rep


@pytest.mark.parametrize("manifold", ["pos", "vel"])
def test_streaming_argmax_matches_reference(manifold):
    """The product streaming scan (_score_axis_argmax, chunked with a
    padded tail) finds the reference's best grid point and score."""
    win, los, cen, coe, r0, o3, o1 = _scene(n=4, c=8, w=20, g=5000, seed=9)
    r0 = r0 if manifold == "pos" else None
    best, arg = dr._score_axis_argmax(
        jnp.asarray(win), jnp.asarray(los), jnp.asarray(cen),
        jnp.asarray(coe), None if r0 is None else jnp.asarray(r0),
        jnp.asarray(o3), jnp.asarray(o1), "quadratic", 1, chunk=1536)
    ref, _ = parity.score_reference(win, los, cen, coe, r0, o3, o1)
    np.testing.assert_array_equal(np.asarray(arg), ref.argmax(1))
    np.testing.assert_allclose(np.asarray(best), ref.max(1), rtol=1e-5)


def test_score_reference_masks_only_tap_boundaries():
    """Points are left out only where a tap index sits within the margin of
    a rounding boundary inside the window."""
    win, los, cen, coe, r0, o3, o1 = _scene(n=1, c=2, w=24, g=4000, seed=2)
    _, keep = parity.score_reference(win, los, cen, coe, r0, o3, o1)
    u = np.einsum("gj,ncj->ncg", o3.astype(np.float64),
                  los.astype(np.float64))
    rng = -u + (np.sum(o3.astype(np.float64) ** 2, 1) - u * u) / (
        2.0 * r0.astype(np.float64)[..., None])
    idx = cen[..., None] + coe[..., None] * (rng + o1)
    frac = idx - np.floor(idx)
    near = np.any(np.abs(frac - 0.5) < parity.TAP_BOUNDARY_MARGIN,
                  axis=(0, 1))
    assert not np.any(keep & near)
    assert keep.sum() >= 0.9 * (~near).sum()
