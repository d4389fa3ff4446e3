"""The frozen work count, pinned: operations and bytes of each kernel's
function at the cells' shapes (level 16, J = 64), as literal numbers. They
equal ``chip_smoke.py``'s ``kernel_work`` as the benchmark was made; a later edit of the
program's count cannot move them."""

import pytest

from mdbench import mint, work
from mdbench.reference.mtp_file import parse_mtp

# (species, atoms, live pairs) -> {kernel: (flops, bytes)}
PINNED = {
    (1, 32000, 1216000): {
        "window_disp": (92160041, 43392036),
        "pair_forces_mega": (2517920000, 65664000),
        "window_giveback": (12288000, 33152000),
        "site_energies_mega": (596576000, 41344000),
        "candidates_mega": (2925888000, 91008000),
    },
    (2, 131072, 4980736): {
        "window_disp": (377487401, 177733668),
        "pair_forces_mega": (10313400320, 268959744),
        "window_giveback": (50331648, 135790592),
        "site_energies_mega": (2443575296, 169345024),
        "candidates_mega": (11984437248, 406323200),
    },
}


@pytest.mark.parametrize("shape", sorted(PINNED))
def test_kernel_work_is_pinned(shape):
    species, n, live = shape
    pot = parse_mtp(mint.dumps_mtp(mint.make_mtp(16, species_count=species, seed=0)))
    for name, want in PINNED[shape].items():
        assert work.kernel_work(name, pot, n, 64, live) == want, name


def test_bounds_and_peak_seconds():
    pot = parse_mtp(mint.dumps_mtp(mint.make_mtp(16, seed=0)))
    bound = work.bound_seconds(work.STEP, pot, 32000, 64, 1216000)
    # K1 and K3 bound by bytes, K2 by operations
    want = (43392036 + 33152000) / work.PEAK_BYTES + 2517920000 / work.PEAK_FLOPS
    assert bound == pytest.approx(want, rel=1e-12)
    peak = work.peak_seconds(work.GRADE, pot, 32000, 64, 1216000)
    want = (92160041 + 12288000) / work.PEAK_FLOPS + 2925888000 / work.PEAK_FLOPS_F64
    assert peak == pytest.approx(want, rel=1e-12)


def test_live_pairs_count_the_fcc_shells():
    import torch

    from mdbench.inputs import lattice

    pos, cell = lattice("fcc", 4.0, (5, 5, 5))
    # within 5.0 A of a perfect fcc site at a = 4.0: 12 + 6 + 24 neighbors
    assert work.live_pairs(torch.as_tensor(pos), torch.as_tensor(cell), 5.0) == 42 * len(pos)
