"""The launch plans of K4's Woodbury set-up and R-column solve across the
card, the route by shape, and K1's F wrapper's refusals.

CPU only: the planners and the wrappers' checks are host code
(``ops/pcr.py:solve_plan`` and ``cols_route``, ``ops/stencil.py:eval_F``).
The kernels themselves are held against
their plain versions and the one-block / per-node bodies on the card
(``tests/test_torch_kernels.py``: ``test_woodbury_setup_matches_plain_version``,
``test_tiled_F_matches_plain_version``).
"""

import pytest
import torch

from triflow_tpu_torch import Model
from triflow_tpu_torch.ops import _launch, kernel_checks, pcr, stencil

torch.set_num_threads(1)

#: H100's shared memory a block may take
BLOCK_SMEM = 227 * 1024

#: chunk counts of the set-up's plans: one and two levels, a prime, the
#: cells' plans (KS 10^6, the ring 999983) and the most chunks K4 takes
SETUP_CHUNKS = (2, 3, 7, 2000, 2041, 16384)


@pytest.mark.parametrize("s2", range(2, 17, 2))
@pytest.mark.parametrize("C", SETUP_CHUNKS)
@pytest.mark.parametrize("B", (1, 4))
def test_setup_plan_fits_the_card_and_covers_every_column_chunk_once(s2, C, B):
    """The set-up's clusters (one per member and column: B s2 of them, K
    CTAs each, ``solve_plan`` of B s2 right-hand sides): every (member,
    column, chunk) owned by exactly one CTA, every CTA with chunks, at most
    MAX_CLUSTER CTAs a cluster and SOLVE_THREADS threads a CTA, the shared
    memory within a block's; a chunk count whose vectors do not fit 16 CTAs
    refused (``max_chunks``); the capacitance's block of 2 s2^2 threads
    within a CTA's."""
    assert 2 * s2 * s2 <= pcr.BLOCK_THREADS
    for item in (4, 8):
        n = B * s2
        if C > pcr.max_chunks(s2, item):
            with pytest.raises(ValueError, match="do not fit"):
                pcr.solve_plan(C, s2, n, item)
            continue
        sp = pcr.solve_plan(C, s2, n, item)
        assert 1 <= sp.K <= pcr.MAX_CLUSTER and sp.Cc & (sp.Cc - 1) == 0
        assert s2 * sp.Ct <= sp.threads <= pcr.SOLVE_THREADS and sp.threads % 32 == 0
        assert sp.smem == pcr.solve_smem(s2, item, sp.Cc, sp.Ct, sp.D)
        assert sp.smem + 2 * s2 * item <= BLOCK_SMEM
        # CTA q of the grid: cluster q // K solves column m % s2 of member
        # m // s2 (m = q // K) over chunks [k Cc, k Cc + Cc) of it, k = q % K
        owned = {}
        for q in range(n * sp.K):
            m, k = divmod(q, sp.K)
            lo, hi = k * sp.Cc, min(C, (k + 1) * sp.Cc)
            assert lo < hi
            owned.setdefault(divmod(m, s2), []).append((lo, hi))
        assert set(owned) == {(b, j) for b in range(B) for j in range(s2)}
        for ranges in owned.values():
            ranges.sort()
            assert ranges[0][0] == 0 and ranges[-1][1] == C
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_setup_route_by_shape():
    """One block per member only at the narrow sizes, for plans of at most
    FACTOR_MEMBERS_MAX_C chunks and MEMBERS_COLS_MIN_B members or more
    (config 5: B = 1024 KS members, C = 100); clusters for one grid, few
    members, many chunks and every wide size; the kernel checks record
    each shape under its route's entry."""
    assert pcr.cols_route(4, 100, 1024) == "members"
    assert pcr.cols_route(4, 100, pcr.MEMBERS_COLS_MIN_B) == "members"
    assert pcr.cols_route(4, 100, pcr.MEMBERS_COLS_MIN_B - 1) == "clusters"
    assert pcr.cols_route(4, pcr.FACTOR_MEMBERS_MAX_C + 1, 1024) == "clusters"
    for s2 in (2, 4, 6, 8):
        for C in (2, 100, 1000, 2000):
            assert pcr.cols_route(s2, C, 1) == "clusters"
    for s2 in (10, 12, 14, 16):
        assert pcr.cols_route(s2, 100, 1024) == "clusters"
    assert kernel_checks.setup_entry(2, 100, 1024) == "K4.pcr_solve_members"
    assert kernel_checks.setup_entry(2, 2000, 1) == "K4.pcr_solve"
    assert kernel_checks.setup_entry(6, 1000, 1) == "K4.pcr_solve_wide"


class FakeCuda:
    """A stand-in for a CUDA tensor: device index, dtype, contiguity and
    shape, as the wrappers' checks read them."""

    def __init__(self, shape, dev=0, dtype=torch.float64, contiguous=True):
        self.shape = torch.Size(shape)
        self.ndim = len(shape)
        self.dev, self.dtype, self.contiguous = dev, dtype, contiguous
        self.is_cuda = dev >= 0
        self.device = torch.device("cuda", dev) if dev >= 0 else torch.device("cpu")

    def get_device(self):
        return self.dev

    def is_contiguous(self):
        return self.contiguous


def test_F_wrapper_refuses_each_fault(monkeypatch):
    """K1's F entry, whose shapes are checked once per shape: a tensor off
    the current device or on the CPU beside CUDA ones, of another dtype,
    not contiguous, of another shape, of another member count, or more
    members than the kernel's grid takes, raises on every call (a refused
    shape is never taken as checked); a CPU ``u`` takes the plain version."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    backend = Model("k * dxxU", "U", "k", device="cpu").backend
    N = 64

    def inputs(B=None, **bad):
        lead = () if B is None else (B,)
        args = {"u": FakeCuda((*lead, 1, N)), "helpers": FakeCuda((*lead, 0, N)),
                "pstack": FakeCuda((*lead, 1, N)), "x": FakeCuda((N,)),
                "bias": FakeCuda((*lead, 1, N))}
        args.update(bad)
        return args

    cases = [
        (inputs(helpers=FakeCuda((0, N), dev=-1)), ValueError, "CUDA tensors"),
        (inputs(u=FakeCuda((1, N), dev=1)), ValueError, "current device"),
        (inputs(bias=FakeCuda((1, N), dtype=torch.float32)), TypeError, "expected"),
        (inputs(pstack=FakeCuda((1, N), contiguous=False)), ValueError, "contiguous"),
        (inputs(bias=FakeCuda((1, N + 1))), ValueError, "bias has shape"),
        (inputs(x=FakeCuda((N + 1,))), ValueError, "has shape"),
        (inputs(B=4, helpers=FakeCuda((3, 0, N))), ValueError, "helpers has shape"),
        (inputs(u=FakeCuda((2, 2, 1, N))), ValueError, "dimensions"),
        (inputs(B=stencil.MAX_MEMBERS + 1), ValueError, "members"),
    ]
    for args, err, match in cases:
        for _ in range(2):
            with pytest.raises(err, match=match):
                stencil.eval_F(backend, args["u"], args["helpers"], args["pstack"],
                               args["x"], True, 0.1, args["bias"])
    # a CPU u takes the plain version, and a meta one is refused
    u = torch.ones((1, N), dtype=torch.float64)
    x = torch.linspace(0.0, 1.0, N, dtype=torch.float64)
    got = stencil.eval_F(backend, u, u[:0], u, x, True)
    assert torch.equal(got, stencil.eval_F_plain(backend, u, u[:0], u, x, True))
    meta = torch.empty((1, N), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        stencil.eval_F(backend, meta, meta[:0], meta, x, True)


def test_new_checks_harness_on_cpu():
    """The tiled F and set-up checks on CPU tensors (a few shapes): plain
    against plain, nothing launched."""
    before = _launch.counts()
    results = kernel_checks.check_all_tiled_F("cpu", torch.float64,
                                              shapes=[(3, 1), (257, 4)])
    kernel_checks.check_all_setups("cpu", torch.float64, results,
                                   cases=[(1, 7, 1), (2, 130, 1), (6, 3, 4)])
    assert results == {"K1.F": 0.0, "K1.F_terms": 0.0, "K4.pcr_solve": 0.0,
                       "K4.pcr_solve_wide": 0.0}
    assert _launch.counts() == before
