"""P1 and P2 as redesigned for Hopper (``csrc/hess_stream.cuh``): the launch
plan, R's two layouts, the split of the solve into its sweep and back
substitution, the row-loop bodies kept beside them, and the wrappers' checks.

On the CPU every wrapper runs its plain version. The split plain versions
(``blocked_sweep_plain`` with R in the kernels' packed-row or column-tile
layout, ``blocked_back_plain``) must give exactly the whole plain solve,
since they run the same operations on the same values. The kernels run only
on a CUDA card (the ``cuda`` tests below, which skip here); there they are
held to the plain versions by chip_smoke.py's bars: the relative residual
‖(H + s_k I)w_k − b_k‖/‖b_k‖ ≤ 5e-5 in complex64 and 1e-12 in complex128,
on systems built as 3I plus a small Hessenberg part or from a reduction."""
import numpy as np
import pytest
import torch

from maus_tpu_torch.ops.kernels import hess_solve as hs

torch.set_num_threads(1)

LIMIT = 232448          # the shared memory a block may use on Hopper


def _system(k, n, dtype, seed=0, device="cpu"):
    """H = 3I plus a random upper-Hessenberg part of norm ~1 (well
    conditioned without a reduction), shifts of modulus ≤ 0.5, standard
    normal right-hand sides; made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)), -1)
    H = H / np.sqrt(2 * n) + 3.0 * np.eye(n)
    s = 0.3 * (rng.standard_normal(k) + 1j * rng.standard_normal(k))
    B = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
    nd = {torch.complex64: np.complex64, torch.complex128: np.complex128}[dtype]
    return tuple(torch.from_numpy(a.astype(nd)).to(device) for a in (H, s, B))


def _residual(H, s, W, B):
    Hh = torch.triu(H, diagonal=-1)
    return float((torch.linalg.vector_norm(W @ Hh.T + s[:, None] * W - B, dim=-1)
                  / torch.linalg.vector_norm(B, dim=-1)).max())


@pytest.mark.parametrize("dtype,n,home", [
    (torch.complex64, 1, "registers"), (torch.complex64, 4096, "registers"),
    (torch.complex64, 4320, "registers"), (torch.complex64, 4321, "shared"),
    (torch.complex64, 16384, "shared"), (torch.complex64, 4320 + 28544, "shared"),
    (torch.complex64, 4320 + 28545, "global"), (torch.complex128, 2400, "registers"),
    (torch.complex128, 2401, "shared"), (torch.complex128, 16384, "shared"),
    (torch.complex128, 2400 + 14272, "shared"), (torch.complex128, 2400 + 14273, "global")])
def test_plan_home_by_shape(dtype, n, home):
    """The carried row's columns past threads × cols (480 × 9 in complex64,
    480 × 5 in complex128) live in shared memory while they fit its budget
    (228352 bytes), then in a global scratch."""
    plan = hs.blocked_plan(32, n, dtype)
    assert plan["home"] == home
    assert plan["threads"] == 480
    assert plan["cols"] == {torch.complex64: 9, torch.complex128: 5}[dtype]
    assert plan["spill_cols"] == max(0, n - 480 * plan["cols"])
    esz = 8 if dtype == torch.complex64 else 16
    assert plan["smem"] == (plan["spill_cols"] * esz if home == "shared" else 0)
    assert plan["smem"] + 4096 <= LIMIT


@pytest.mark.parametrize("k,n,cluster", [
    (32, 4096, 4), (1, 4096, 8), (16, 4096, 8), (33, 4096, 4), (66, 4096, 2),
    (200, 4096, 2), (1, 64, 1), (200, 64, 1), (200, 128, 1), (1, 65, 2),
    (1, 130, 3), (32, 16384, 4)])
def test_plan_cluster_by_shape(k, n, cluster):
    """Without the card's occupancy: the SMs shared out among the
    candidates, at most one CTA a block of 64 columns and at most 8, at
    least 2 past two blocks."""
    assert hs.blocked_plan(k, n, torch.complex64)["cluster"] == cluster


# clusters of C back-substitution CTAs an H100 runs at once, complex64 (the
# card's cudaOccupancyMaxActiveClusters, tools/hess_blocked_ab.py --scan)
ACTIVE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


@pytest.mark.parametrize("k,n,cluster", [
    (32, 4096, 3), (28, 4096, 4), (16, 4096, 6), (15, 4096, 8), (1, 4096, 8),
    (40, 4096, 2), (66, 4096, 2), (67, 4096, 3), (200, 4096, 2), (1, 130, 3),
    (1, 128, 2), (1, 64, 1), (200, 64, 1), (32, 16384, 3)])
def test_plan_cluster_by_occupancy(k, n, cluster):
    """With the card's occupancy: the largest cluster whose K clusters all
    run in one wave, else the fewest waves (K = 67: two waves at 2 or 3
    CTAs, the larger taken), and at least 2 CTAs past two blocks of 64
    columns, where a worker CTA computes the far sums."""
    assert hs.blocked_plan(k, n, torch.complex64, active=ACTIVE.get)["cluster"] == cluster


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("cluster", range(1, 9))
def test_plan_back_smem_fits(dtype, cluster):
    plan = hs.blocked_plan(1, 1000 if cluster > 1 else 128, dtype, cluster=cluster)
    assert plan["cluster"] == cluster
    esz = 8 if dtype == torch.complex64 else 16
    assert plan["back_smem"] == (3 * 64 * 65 + 6 * 64) * esz
    assert plan["back_smem"] <= LIMIT


@pytest.mark.parametrize("args,exc", [
    ((1, 64, torch.complex64, 0), ValueError), ((1, 64, torch.complex64, 9), ValueError),
    ((1, 129, torch.complex64, 1), ValueError), ((1, 1000, torch.complex128, 1), ValueError),
    ((1, 64, torch.float32, None), ValueError), ((1, 64, torch.complex32, None), ValueError),
    ((0, 64, torch.complex64, None), ValueError), ((1, 0, torch.complex64, None), ValueError)])
def test_plan_refuses(args, exc):
    with pytest.raises(exc):
        hs.blocked_plan(*args)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("n", [1, 7, 64, 65, 130, 200])
def test_r_layout_fills_r_elems(tiled, n):
    """Every entry of the upper triangle has its own place inside the
    candidate's r_elems(N) elements; packed rows fill them exactly."""
    _, _, flat = hs._r_layout(n, tiled, "cpu")
    assert flat.numel() == n * (n + 1) // 2
    assert torch.unique(flat).numel() == flat.numel()
    assert int(flat.min()) >= 0 and int(flat.max()) < hs.r_elems(n, tiled)
    if not tiled:
        assert hs.r_elems(n, False) == n * (n + 1) // 2


def test_tiled_layout_keeps_a_blocks_rows_contiguous():
    """P2's tile t: columns [64t, 64t + 64) of rows 0.., row-major with a row
    stride of 64, tiles one after another."""
    n = 130
    rows, cols, flat = hs._r_layout(n, True, "cpu")
    place = {(int(r), int(c)): int(f) for r, c, f in zip(rows, cols, flat)}
    assert place[(0, 0)] == 0 and place[(0, 63)] == 63
    assert place[(1, 64)] - place[(0, 64)] == 64
    assert place[(0, 64)] == 64 * 64
    assert place[(0, 128)] == 3 * 64 * 64


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("k,n", [(1, 1), (2, 7), (3, 64), (2, 130)])
def test_split_plain_equals_whole_plain(tiled, dtype, k, n):
    """Sweep then back substitution through R in the kernels' layout gives
    the whole plain solve bit for bit, on the CPU without a launch."""
    H, s, B = _system(k, n, dtype, seed=n)
    counts = (hs.LAUNCHES_SWEEP, hs.LAUNCHES_BACK, hs.LAUNCHES_V2, hs.LAUNCHES_V3)
    R, Y = hs.blocked_sweep(H, s, B, tiled)
    assert R.shape == (k * hs.r_elems(n, tiled),) and Y.shape == (k, n)
    x = hs.blocked_back(R, Y, tiled)
    whole = (hs.hess_solve_v3 if tiled else hs.hess_solve_v2)(H, s, B)
    assert (hs.LAUNCHES_SWEEP, hs.LAUNCHES_BACK, hs.LAUNCHES_V2, hs.LAUNCHES_V3) == counts
    assert torch.equal(x, whole)
    assert _residual(H, s, x, B) <= (5e-5 if dtype == torch.complex64 else 1e-12)


@pytest.mark.parametrize("tiled", [False, True])
def test_rowloop_runs_the_plain_version_on_cpu(tiled):
    """the row-loop bodies kept: on the CPU the whole solve is the plain version,
    and the sweep-only mode returns the sweep's rotated right-hand sides."""
    H, s, B = _system(3, 70, torch.complex128, seed=1)
    rowloop = hs.hess_solve_v3_rowloop if tiled else hs.hess_solve_v2_rowloop
    plain = hs.hess_solve_v3_plain if tiled else hs.hess_solve_v2_plain
    counts = (hs.LAUNCHES_V2_ROWLOOP, hs.LAUNCHES_V3_ROWLOOP)
    assert torch.equal(rowloop(H, s, B), plain(H, s, B))
    assert torch.equal(rowloop(H, s, B, sweep_only=True), hs.blocked_sweep(H, s, B, tiled)[1])
    assert (hs.LAUNCHES_V2_ROWLOOP, hs.LAUNCHES_V3_ROWLOOP) == counts


def _bad_back_calls():
    R = torch.zeros(3 * hs.r_elems(4, False), dtype=torch.complex64)
    Y = torch.zeros((3, 4), dtype=torch.complex64)
    return {
        "Y real": ((R, Y.real.contiguous()), TypeError),
        "Y 1-D": ((R, Y.reshape(-1)), TypeError),
        "R short": ((R[:-1], Y), ValueError),
        "R of another dtype": ((R.to(torch.complex128), Y), ValueError),
        "R 2-D": ((R.reshape(3, -1), Y), ValueError),
        "Y transposed view": ((torch.zeros(3 * hs.r_elems(3, False), dtype=torch.complex64),
                               torch.zeros((3, 4), dtype=torch.complex64).T), ValueError),
        "empty": ((torch.zeros(0, dtype=torch.complex64),
                   torch.zeros((0, 4), dtype=torch.complex64)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_back_calls()))
def test_blocked_back_rejects(case):
    args, exc = _bad_back_calls()[case]
    with pytest.raises(exc):
        hs.blocked_back(*args)


@pytest.mark.parametrize("solve", ["hess_solve_v2", "hess_solve_v3"])
@pytest.mark.parametrize("cluster", [0, 9])
def test_wrapper_rejects_cluster(solve, cluster):
    H, s, B = _system(2, 8, torch.complex64)
    with pytest.raises(ValueError):
        getattr(hs, solve)(H, s, B, cluster=cluster)


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")


VARIANTS = {"v2": (hs.hess_solve_v2, hs.hess_solve_v2_plain, False),
            "v3": (hs.hess_solve_v3, hs.hess_solve_v3_plain, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cluster", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_every_cluster_size_on_card(variant, cluster, dtype):
    """Clusters of 2-8 CTAs at N = 1000 (16 blocks); one CTA at N = 128,
    where no target has a far sum."""
    _card()
    solve, plain, _ = VARIANTS[variant]
    H, s, B = _system(3, 1000 if cluster > 1 else 128, dtype, seed=cluster,
                      device="cuda")
    w = solve(H, s, B, cluster=cluster)
    bar = 5e-5 if dtype == torch.complex64 else 1e-12
    assert _residual(H, s, w, B) <= bar
    assert _residual(H, s, plain(H, s, B), B) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype,k,n", [
    (torch.complex64, 2, 2), (torch.complex64, 3, 63), (torch.complex64, 3, 65),
    (torch.complex64, 2, 4321), (torch.complex64, 2, 6000),
    (torch.complex128, 2, 2401), (torch.complex128, 2, 3000)])
def test_ragged_shapes_and_homes_on_card(variant, dtype, k, n):
    """Ragged blocks (N = 2, 63, 65) and the carried row in shared memory
    (N past 4320 in complex64, 2400 in complex128)."""
    _card()
    solve, plain, _ = VARIANTS[variant]
    H, s, B = _system(k, n, dtype, seed=n, device="cuda")
    bar = 5e-5 if dtype == torch.complex64 else 1e-12
    assert _residual(H, s, solve(H, s, B), B) <= bar
    assert _residual(H, s, plain(H, s, B), B) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("cluster", [2, 4])
def test_zero_pivot_in_a_later_block_on_card(variant, cluster):
    """H = e₀e₁ᵀ at N = 130 with zero shifts: R's last diagonal is an exact
    zero, and the non-finite value reaches every row through the blocked
    back substitution, its far sums and the near ones, on two and four
    CTAs."""
    _card()
    n = 130
    H = torch.zeros((n, n), dtype=torch.complex64, device="cuda")
    H[0, 1] = 1.0
    w = VARIANTS[variant][0](H, torch.zeros(2, dtype=torch.complex64, device="cuda"),
                             torch.ones((2, n), dtype=torch.complex64, device="cuda"),
                             cluster=cluster)
    assert not torch.isfinite(torch.view_as_real(w)).all(dim=-1).all(dim=-1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_split_kernels_match_the_whole_solve_on_card(tiled, dtype):
    """blocked_sweep then blocked_back run the two kernels of one whole
    call apart: the same result bit for bit; R's layout agrees with the
    plain sweep's, and each wrapper counts its own launch."""
    _card()
    H, s, B = _system(3, 200, dtype, seed=2, device="cuda")
    counts = (hs.LAUNCHES_SWEEP, hs.LAUNCHES_BACK)
    R, Y = hs.blocked_sweep(H, s, B, tiled)
    x = hs.blocked_back(R, Y, tiled)
    assert (hs.LAUNCHES_SWEEP, hs.LAUNCHES_BACK) == (counts[0] + 1, counts[1] + 1)
    whole = (hs.hess_solve_v3 if tiled else hs.hess_solve_v2)(H, s, B)
    assert torch.equal(x, whole)
    Rp, Yp = hs.blocked_sweep_plain(H, s, B, tiled)
    rows, cols, flat = hs._r_layout(200, tiled, "cuda")
    got = R.reshape(3, -1)[:, flat]
    want = Rp.reshape(3, -1)[:, flat]
    tol = 1e-5 if dtype == torch.complex64 else 1e-13
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert float((Y - Yp).abs().max()) <= tol * float(Yp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["v2", "v3"])
@pytest.mark.parametrize("dtype,k,n", [(torch.complex64, 7, 129),
                                       (torch.complex128, 2, 600)])
def test_rowloop_bodies_on_card(variant, dtype, k, n):
    """the row-loop bodies as kept: the whole solve at the bar, the sweep-only
    mode equal to the redesign's sweep in y within rounding, one launch a
    call on their own counters."""
    _card()
    rowloop = getattr(hs, f"hess_solve_{variant}_rowloop")
    counter = f"LAUNCHES_{variant.upper()}_ROWLOOP"
    H, s, B = _system(k, n, dtype, seed=5, device="cuda")
    before = getattr(hs, counter)
    w = rowloop(H, s, B)
    y = rowloop(H, s, B, sweep_only=True)
    assert getattr(hs, counter) == before + 2
    bar = 5e-5 if dtype == torch.complex64 else 1e-12
    assert _residual(H, s, w, B) <= bar
    y_new = hs.blocked_sweep(H, s, B, variant == "v3")[1]
    tol = 1e-5 if dtype == torch.complex64 else 1e-13
    assert float((y - y_new).abs().max()) <= tol * float(y_new.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_back_occupancy_on_card(tiled, dtype):
    """Every cluster size has room for at least one cluster on the card, and
    the wrappers' plan at (32, 4096) runs its 32 clusters in one wave."""
    _card()
    for cluster in range(1, 9):
        assert hs.back_occupancy(cluster, dtype, tiled) >= 1
    plan = hs.card_plan(32, 4096, dtype, tiled)
    assert hs.back_occupancy(plan["cluster"], dtype, tiled) >= 32
