"""The port's entry points (``mtp_tpu_torch.entry``), twins of the JAX
package's ``__graft_entry__.py``: the flagship force step against the JAX
one, and the multi-rank dry run on gloo rank processes on the CPU."""

import jax
import numpy as np
import pytest
import torch

from mtp_tpu_torch.entry import dryrun_multichip, entry, main

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)


def test_entry_matches_the_jax_entry():
    """fp32 on both sides (the port's window path through the plain twins
    on the CPU): the energy within 2e-6 relative, forces within 2e-4 eV/A
    of the JAX package's ``entry()``."""
    import __graft_entry__ as graft

    fn, (p,) = entry(device="cpu")
    jfn, (jp,) = graft.entry()
    # off the lattice (no force there), well inside both frozen lists
    shift = np.random.default_rng(0).normal(0.0, 0.02, p.shape).astype(np.float32)
    e, f = fn(p + torch.as_tensor(shift))
    je, jf = jax.jit(jfn)(jp + shift)
    assert float(e) == pytest.approx(float(je), rel=2e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=2e-4)
    assert np.abs(np.asarray(jf)).max() > 1e-2


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip(n_ranks):
    """The JAX dry run's sequence on 2 ranks (slabs) and 4 (slabs, then 2x2
    bricks): every rank passes its checks and the replicated numbers agree."""
    ranks = dryrun_multichip(n_ranks)
    assert len(ranks) == n_ranks
    assert ranks[0]["grid"] == (4, 2, 2)  # the row-gather box: 2 bins across
    for r in ranks:
        for k in ("pe", "window_pe", "max_grade", "window_max_grade"):
            assert r[k] == ranks[0][k]
    assert (ranks[0]["brick_pe"] is None) == (n_ranks < 4)


def test_cli_on_one_rank(capsys):
    assert main(["1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry(): energy =" in out and "dryrun_multichip(1): OK" in out
