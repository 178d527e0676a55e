"""Kernel K3's complex64 path on the tensor cores: split-TF32 ("3xTF32")
products.

On the CPU: the split :func:`tf32_split` against a bit-level numpy
reference of ``cvt.rna.tf32.f32`` (round to 10 stored mantissa bits, ties
away from zero); the scheme's emulation :func:`cgemm_tf32x3_plain` against
numpy's complex128 product at the bar the port holds K3 to,
4·K·ε₃₂·max|a|·max|b| (the ratio err/bar is recorded as a property), and
against the Pallas kernel ``maus_tpu.ops.pallas.cgemm.cgemm`` run in
interpret mode at tests/test_pallas.py's rtol/atol of 2e-4. The kernel
itself runs only on a CUDA card (the ``cuda`` tests below, which skip
here)."""
import numpy as np
import pytest
import torch

from maus_tpu_torch.ops.kernels import cgemm as kc

try:
    import jax.numpy as jnp

    from maus_tpu.ops.pallas.cgemm import cgemm as cgemm_pallas
except ImportError:     # a GPU machine without JAX runs the cuda tests only
    jnp = cgemm_pallas = None

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
# the shapes of the cuda K3 tests in tests/test_torch_cgemm.py
SHAPES = [(1, 1, 1), (100, 130, 50), (8, 128, 128), (65, 17, 129), (300, 1, 200)]


def _rand(rng, *shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _bar(a, b, eps=EPS32):
    return 4 * a.shape[-1] * eps * np.abs(a).max() * np.abs(b).max()


def _rna_tf32_reference(x):
    """cvt.rna.tf32.f32 by exact float64 arithmetic: round |x| to a multiple
    of the tf32 quantum (2^(e−11) for x = m·2^e, m in [0.5, 1); 2^−136 for
    float32 subnormals), halves away from zero; inf past the float32 range;
    NaN, ±inf and ±0 unchanged."""
    x = np.asarray(x, np.float32)
    out = np.empty_like(x)
    for i, v in enumerate(x.astype(np.float64)):
        if not np.isfinite(v) or v == 0:
            out[i] = v
            continue
        _, e = np.frexp(abs(v))
        q = 2.0 ** (max(int(e), -125) - 11)
        r = np.floor(abs(v) / q + 0.5) * q
        out[i] = np.copysign(np.inf if r >= 2.0 ** 128 else r, v)
    return out


def _split_inputs():
    t = 2.0 ** -11                        # half a tf32 ulp at 1
    sub = 2.0 ** -136                     # the tf32 quantum among subnormals
    ties = [1 + t, 1 + 3 * t, 1.5 + t, 2 ** 20 * (1 + t), 2.0 ** -100 * (1 + t)]
    near = [1 + t * (1 - 2 ** -12), 1 + t * (1 + 2 ** -12)]
    subnormals = [sub / 2, sub * 1.5, sub * 0.25, 2.0 ** -149, 2.0 ** -127 + sub / 2]
    special = [0.0, np.inf, 3.4028235e38, 3.3e38]
    rng = np.random.default_rng(7)
    normal = list(rng.standard_normal(200) * 10.0 ** rng.integers(-30, 30, 200))
    vals = np.array(ties + near + subnormals + special + normal, np.float64)
    return np.concatenate([vals, -vals]).astype(np.float32)


def test_tf32_split_bits_match_the_reference():
    x = _split_inputs()
    big, small = kc.tf32_split(torch.from_numpy(x))
    big, small = big.numpy(), small.numpy()
    want = _rna_tf32_reference(x)
    np.testing.assert_array_equal(big.view(np.uint32), want.view(np.uint32))
    fin = np.isfinite(big)
    r = (x[fin].astype(np.float64) - big[fin].astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(small[fin].view(np.uint32),
                                  _rna_tf32_reference(r).view(np.uint32))
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small[fin].view(np.uint32) & 0x1FFF).any()
    normal = fin & (np.abs(x) >= np.finfo(np.float32).tiny)
    resid = np.abs(x[normal].astype(np.float64) - big[normal] - small[normal])
    assert (resid <= 2.0 ** -22 * np.abs(x[normal].astype(np.float64))).all()


@pytest.mark.parametrize("v,want", [(1 + 2.0 ** -11, 1 + 2.0 ** -10),
                                    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
                                    (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),
                                    (2.0 ** -137, 2.0 ** -136),
                                    (-(2.0 ** -138), -0.0)])
def test_tf32_split_ties_go_away_from_zero(v, want):
    big, _ = kc.tf32_split(torch.tensor([v], dtype=torch.float32))
    assert big.numpy().view(np.uint32)[0] == \
        np.array([want], np.float32).view(np.uint32)[0]


def test_tf32_split_special_values():
    x = torch.tensor([0.0, -0.0, np.inf, -np.inf, np.nan], dtype=torch.float32)
    big, small = kc.tf32_split(x)
    assert big[:4].numpy().view(np.uint32).tolist() == \
        x[:4].numpy().view(np.uint32).tolist()
    assert small[:2].numpy().view(np.uint32).tolist() == [0, 0]
    assert bool(torch.isnan(big[4])) and bool(torch.isnan(small[4]))
    # inf − inf: an infinite operand gives a NaN small half, as on the card
    assert bool(torch.isnan(small[2:4]).all())
    with pytest.raises(TypeError):
        kc.tf32_split(x.double())


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tf32x3_plain_within_the_k3_bar(m, k, n, record_property):
    worst = 0.0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        a, b = _rand(rng, m, k), _rand(rng, k, n)
        got = kc.cgemm_tf32x3_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        exact = a.astype(np.complex128) @ b.astype(np.complex128)
        worst = max(worst, float(np.abs(got - exact).max() / _bar(a, b)))
    record_property("err_over_bar", worst)
    assert got.dtype == np.complex64
    assert worst <= 1.0


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (16, 256, 64), (100, 130, 50)])
def test_tf32x3_plain_matches_interpret_mode_pallas(m, k, n):
    pytest.importorskip("jax")
    rng = np.random.default_rng(0)
    a, b = _rand(rng, m, k), _rand(rng, k, n)
    want = np.asarray(cgemm_pallas(jnp.asarray(a), jnp.asarray(b), bm=8, bn=128,
                                   bk=128, interpret=True))
    got = kc.cgemm_tf32x3_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_tf32x3_plain_rejects():
    a = torch.zeros((3, 4), dtype=torch.complex128)
    with pytest.raises(TypeError):
        kc.cgemm_tf32x3_plain(a, a.T.contiguous())
    with pytest.raises(ValueError, match="bad shapes"):
        kc.cgemm_tf32x3_plain(a.to(torch.complex64), a.to(torch.complex64))


@pytest.mark.parametrize("shape", [(7, 5), (2, 3, 4), (0,)])
def test_tf32_split_keeps_shape_on_views(shape):
    """A non-contiguous view splits as its contiguous copy does."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(shape + (2,)).astype(np.float32))[..., 0]
    big, small = kc.tf32_split(x)
    want_big, want_small = kc.tf32_split(x.contiguous())
    assert big.shape == small.shape == x.shape
    assert torch.equal(big, want_big) and torch.equal(small, want_small)


@pytest.mark.parametrize("scale_a,scale_b", [(2.0 ** 30, 2.0 ** 30),
                                             (2.0 ** -30, 2.0 ** -30),
                                             (2.0 ** 40, 2.0 ** -40)])
def test_tf32x3_plain_within_the_k3_bar_at_scale(scale_a, scale_b):
    """The split is relative: scaled operands keep the unchanged bar."""
    rng = np.random.default_rng(3)
    a = _rand(rng, 40, 70) * np.float32(scale_a)
    b = _rand(rng, 70, 30) * np.float32(scale_b)
    got = kc.cgemm_tf32x3_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    exact = a.astype(np.complex128) @ b.astype(np.complex128)
    assert np.abs(got - exact).max() <= _bar(a, b)


def test_simt_wrappers_run_the_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    a, b = _rand(rng, 20, 30), _rand(rng, 30, 10)
    counts = kc.LAUNCHES, kc.LAUNCHES_SIMT
    got = kc.cgemm_simt(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    C = torch.zeros((20, 10), dtype=torch.complex64)
    kc.cgemm_update_simt(C, torch.from_numpy(a), torch.from_numpy(b), 2.0, 0.0)
    assert (kc.LAUNCHES, kc.LAUNCHES_SIMT) == counts
    exact = a.astype(np.complex128) @ b.astype(np.complex128)
    assert np.abs(got - exact).max() <= _bar(a, b)
    assert np.abs(C.numpy() - 2 * exact).max() <= 2 * _bar(a, b)


# ---- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")


def _card(seed, *shape, dtype=torch.complex64):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rdt = dtype.to_real()
    return torch.complex(torch.randn(*shape, generator=g, dtype=rdt, device="cuda"),
                         torch.randn(*shape, generator=g, dtype=rdt, device="cuda"))


def _update_bar(A, B, alpha=1.0):
    k = A.shape[-1]
    return 4 * max(k, 1) * EPS32 * float(A.abs().max()) * float(B.abs().max()) * \
        max(1.0, abs(alpha)) if A.numel() and B.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("batch,m,k,n", [(3, 65, 17, 129), (2, 300, 33, 200),
                                         (1, 129, 160, 127), (2, 64, 64, 64)])
def test_update_matches_plain_on_card(batch, m, k, n):
    """Ragged tiles and k-slices, complex α and β."""
    _need_card()
    A, B, C = _card(1, batch, m, k), _card(2, batch, k, n), _card(3, batch, m, n)
    Cp = C.clone()
    launches = kc.LAUNCHES
    kc.cgemm_update(C, A, B, 0.5 - 2j, 1j)
    kc.cgemm_update_plain(Cp, A, B, 0.5 - 2j, 1j)
    torch.cuda.synchronize()
    assert kc.LAUNCHES == launches + 1
    bar = _update_bar(A, B, 0.5 - 2j) + 4 * EPS32 * float(Cp.abs().max())
    assert float((C - Cp).abs().max()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,e", [(131, 1, 65), (129, 0, 64), (70, 10, 25)])
def test_misaligned_views_take_eight_byte_copies_on_card(n, s, e):
    """Views into one (3, n, n) buffer laid out as the LU's trailing update;
    odd n or odd offsets leave rows 8-byte aligned only."""
    _need_card()
    X = _card(4, 3, n, n)
    Xp = X.clone()
    C, A, B = X[:, e:, e:], X[:, e:, s:e], X[:, s:e, e:]
    kc.cgemm_update(C, A, B, -1.0, 1.0)
    kc.cgemm_update_plain(Xp[:, e:, e:], Xp[:, e:, s:e], Xp[:, s:e, e:], -1.0, 1.0)
    torch.cuda.synchronize()
    bar = _update_bar(A, B) + 2 * EPS32 * float(X.abs().max())
    assert float((X - Xp).abs().max()) <= bar
    assert torch.equal(X[:, :e], Xp[:, :e])
    assert torch.equal(X[:, e:, :e], Xp[:, e:, :e])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1])
def test_beta_zero_with_nan_in_c_and_tiny_k_on_card(k):
    _need_card()
    A, B = _card(5, 2, 70, k), _card(6, 2, k, 90)
    C = torch.full((2, 70, 90), complex(float("nan"), float("nan")),
                   dtype=torch.complex64, device="cuda")
    kc.cgemm_update(C, A, B, 1.0, 0.0)
    want = kc.cgemm_update_plain(torch.zeros_like(C), A, B, 1.0, 0.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.view_as_real(C)).all())
    assert float((C - want).abs().max()) <= _update_bar(A, B)
    if k == 0:
        assert not bool(C.abs().any())
        D = _card(7, 2, 70, 90)
        Dp = D.clone()
        kc.cgemm_update(D, A, B, 1.0, 2.0)           # C = β·C alone
        torch.cuda.synchronize()
        assert torch.equal(D, 2 * Dp)


@pytest.mark.cuda
def test_first_trailing_update_at_4096_on_card():
    """P4's first trailing update at (8, 4096): (batch, M, N, K) =
    (8, 4032, 4032, 64), on views into one buffer, α = −1, β = 1."""
    _need_card()
    X = _card(8, 8, 4096, 4096)
    e = 64
    Xp = X.clone()
    kc.cgemm_update(X[:, e:, e:], X[:, e:, :e], X[:, :e, e:], -1.0, 1.0)
    kc.cgemm_update_plain(Xp[:, e:, e:], Xp[:, e:, :e], Xp[:, :e, e:], -1.0, 1.0)
    torch.cuda.synchronize()
    amax = float(Xp.abs().max())
    bar = 4 * e * EPS32 * amax ** 2 + 2 * EPS32 * amax
    assert float((X - Xp).abs().max()) <= bar
    assert torch.equal(X[:, :e], Xp[:, :e])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_simt_matches_plain_on_card(dtype, m, k, n):
    _need_card()
    a, b = _card(1, m, k, dtype=dtype), _card(2, k, n, dtype=dtype)
    counts = kc.LAUNCHES, kc.LAUNCHES_SIMT
    got = kc.cgemm_simt(a, b)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES, kc.LAUNCHES_SIMT) == (counts[0], counts[1] + 1)
    eps = EPS32 if dtype == torch.complex64 else EPS64
    bar = 4 * k * eps * float(a.abs().max()) * float(b.abs().max())
    assert float((got - kc.cgemm_plain(a, b)).abs().max()) <= bar


@pytest.mark.cuda
def test_launch_counters_on_card():
    _need_card()
    a, b = _card(1, 64, 64), _card(2, 64, 64)
    counts = kc.LAUNCHES, kc.LAUNCHES_SIMT
    kc.cgemm(a, b)
    assert (kc.LAUNCHES, kc.LAUNCHES_SIMT) == (counts[0] + 1, counts[1])
    kc.cgemm_simt(a, b)
    kc.cgemm_update_simt(torch.empty_like(a), a, b)
    assert (kc.LAUNCHES, kc.LAUNCHES_SIMT) == (counts[0] + 1, counts[1] + 2)
    kc.cgemm(a.to(torch.complex128), b.to(torch.complex128))
    torch.cuda.synchronize()
    assert (kc.LAUNCHES, kc.LAUNCHES_SIMT) == (counts[0] + 2, counts[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
def test_kernel_fits_an_sm_on_card(width):
    """Each copy width's kernel gets its dynamic shared memory and at least
    one CTA an SM."""
    _need_card()
    import ctypes

    from maus_tpu_torch.ops.kernels.build import library

    out = (ctypes.c_int * 4)()
    assert library().maus_cgemm_tc_attrs(width, out) == 0
    assert out[2] >= 1
