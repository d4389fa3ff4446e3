"""MTP coefficient fitting (training) on energy/force data.

Port of ``mtp_tpu/train/fit.py``: read a ``.cfg`` training set (or any
arrays), fit the MTP coefficients, write a ``.mtp``, then run MD and active
learning on it and retrain on the selected configurations.

Configurations are padded to a common atom count N_max and evaluated as ONE
batch of C * N_max atoms through the plain chain of
:mod:`mtp_tpu_torch.ops.moments` (the JAX package vmaps its model over the
batch): neighbor indices are offset by k * N_max, each atom carries its own
configuration's cell, and per-configuration sums are a reshape to
(C, N_max). The force loss needs a second derivative, so training runs on
the plain path with ``create_graph=True``, as the JAX fit runs on XLA and
not on its Pallas kernels; the CUDA kernels' autograd Functions have no
double backward, and a fit step launches none of them. The optimizer is
``torch.optim.Adam`` in place of ``optax.adam`` (which imports jax): both put
eps outside the square root of the bias-corrected second moment. A
linear least-squares warm start fits the coefficients the energy is linear
in (species constants and basis weights).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mtp_tpu_torch.io.cfg_file import Config
from mtp_tpu_torch.models.mtp import MTPCoeffs
from mtp_tpu_torch.ops.moments import MTPSchedule, basic_moments, contract_dag, site_energies
from mtp_tpu_torch.ops.window_disp import inverse_cell, minimum_image
from mtp_tpu_torch.utils.device import resolve_device
from mtp_tpu_torch.utils.native import cell_list_host


@dataclasses.dataclass
class Dataset:
    """Padded, batched training data (C configurations, N_max atoms each),
    on one device. ``inv_cells`` are the cells' inverses, taken once here
    because they do not depend on the coefficients."""

    positions: torch.Tensor  # (C, N, 3)
    types: torch.Tensor  # (C, N) int32
    real: torch.Tensor  # (C, N) bool
    nbr_idx: torch.Tensor  # (C, N, J) int32 (self-padded)
    cells: torch.Tensor  # (C, 3, 3)
    energies: torch.Tensor  # (C,)
    forces: torch.Tensor  # (C, N, 3)
    has_forces: torch.Tensor  # (C,) bool
    inv_cells: torch.Tensor  # (C, 3, 3)

    @property
    def n_configs(self):
        return self.positions.shape[0]


def make_dataset(
    configs: Sequence[Config],
    cutoff: float,
    *,
    max_neighbors: int = 64,
    dtype=torch.float64,
    device="cuda",
) -> Dataset:
    """Build a padded dataset from parsed .cfg configurations (host side).
    Raises ``ValueError`` on a neighbor overflow and on a cell narrower than
    2 * cutoff."""
    dev = resolve_device(device)
    n_max = max(len(c.positions) for c in configs)
    C = len(configs)
    pos = np.zeros((C, n_max, 3))
    typ = np.zeros((C, n_max), np.int32)
    real = np.zeros((C, n_max), bool)
    idx = np.tile(np.arange(n_max, dtype=np.int32)[None, :, None], (C, 1, max_neighbors))
    cells = np.zeros((C, 3, 3))
    es = np.zeros(C)
    fs = np.zeros((C, n_max, 3))
    hasf = np.zeros(C, bool)
    for k, c in enumerate(configs):
        n = len(c.positions)
        pos[k, :n] = c.positions
        typ[k, :n] = c.types
        real[k, :n] = True
        cells[k] = c.cell
        nbr, _, ovf = cell_list_host(c.positions, c.cell, cutoff, max_neighbors)
        if ovf:
            raise ValueError(f"config {k}: neighbor overflow at J={max_neighbors}")
        idx[k, :n] = nbr
        if c.energy is not None:
            es[k] = c.energy
        if c.forces is not None:
            fs[k, :n] = c.forces
            hasf[k] = True
    cells_t = torch.as_tensor(cells, dtype=dtype, device=dev)
    return Dataset(
        positions=torch.as_tensor(pos, dtype=dtype, device=dev),
        types=torch.as_tensor(typ, device=dev),
        real=torch.as_tensor(real, device=dev),
        nbr_idx=torch.as_tensor(idx, device=dev),
        cells=cells_t,
        energies=torch.as_tensor(es, dtype=dtype, device=dev),
        forces=torch.as_tensor(fs, dtype=dtype, device=dev),
        has_forces=torch.as_tensor(hasf, device=dev),
        inv_cells=torch.stack([inverse_cell(c) for c in cells_t]),
    )


def _tensors(coeffs: MTPCoeffs):
    return coeffs.radial_coeffs, coeffs.species_coeffs, coeffs.moment_coeffs


def _batch_geometry(sched, data, positions):
    """Displacements (C*N, J, 3), the pad mask (C*N, J) and the center and
    neighbor types of the whole batch, flattened to C*N atoms with each
    atom's neighbor indices offset into its own configuration."""
    C, N, J = data.nbr_idx.shape
    dev = positions.device
    nbr = data.nbr_idx.long()
    flat = (nbr + (torch.arange(C, device=dev) * N)[:, None, None]).reshape(C * N, J)

    def per_atom(m):  # (C, 3, 3) -> (3, 3, C*N, 1): each atom's own cell
        return m.repeat_interleave(N, dim=0).permute(1, 2, 0)[..., None]

    pos = positions.reshape(C * N, 3)
    disp = minimum_image(pos[flat] - pos[:, None, :], per_atom(data.cells),
                         per_atom(data.inv_cells))
    d2 = torch.sum(disp * disp, dim=-1)
    real = data.real.reshape(C * N)
    self_pair = (nbr == torch.arange(N, device=dev)[None, :, None]).reshape(C * N, J)
    mask = (d2 <= sched.max_dist**2) & ~self_pair & real[flat] & real[:, None]
    types = data.types.reshape(C * N).long()
    return disp, mask, types, types[flat]


def _config_energies(sched, coeffs, data, positions):
    """Total energy of each configuration (C,); pad atoms contribute 0."""
    disp, mask, it, jt = _batch_geometry(sched, data, positions)
    e = site_energies(sched, coeffs, disp, mask, it, jt)
    e = torch.where(data.real.reshape(-1), e, torch.zeros_like(e))
    return e.reshape(data.real.shape).sum(1)


def _basis_features(sched, coeffs, data):
    """Per configuration, the sums over its atoms of the basis members
    (C, n_scalar) and the species counts (C, S): the design rows of the
    linear warm start (E is linear in moment_coeffs and species_coeffs)."""
    disp, mask, it, jt = _batch_geometry(sched, data, data.positions)
    mb, _ = basic_moments(sched, coeffs, disp, mask, it, jt)
    m = contract_dag(sched, mb)
    w = data.real.reshape(-1).to(m.dtype)[:, None]
    C, N = data.real.shape
    mapping = torch.as_tensor(sched.mapping, device=m.device)
    basis = (m[:, mapping] * w).reshape(C, N, -1).sum(1)
    counts = (torch.nn.functional.one_hot(it, sched.species_count).to(m.dtype) * w)
    return basis, counts.reshape(C, N, -1).sum(1)


def linear_warm_start(sched: MTPSchedule, coeffs: MTPCoeffs, data: Dataset) -> MTPCoeffs:
    """Least-squares fit of (species_coeffs, moment_coeffs) on energies with
    the radial coefficients held fixed.

    The minimum-norm solution with singular values under eps * max(C, cols)
    of the largest cut, as ``jnp.linalg.lstsq``: the small (C, S + n_scalar)
    system is solved in float64 on the host by ``gelsd`` (an SVD solve; the
    CUDA ``lstsq`` has only ``gels``, which needs a full-rank tall matrix,
    and a level-16 warm start from fewer than 67 configurations is
    underdetermined)."""
    with torch.no_grad():
        basis, counts = _basis_features(sched, coeffs, data)
        A = torch.cat([counts, basis], dim=1).cpu().double()
        sol = torch.linalg.lstsq(A, data.energies.cpu().double()[:, None],
                                 driver="gelsd").solution[:, 0]
    S = sched.species_count
    dev = coeffs.species_coeffs.device
    return MTPCoeffs(
        radial_coeffs=coeffs.radial_coeffs,
        species_coeffs=sol[:S].to(coeffs.species_coeffs.dtype).to(dev),
        moment_coeffs=sol[S:].to(coeffs.moment_coeffs.dtype).to(dev),
    )


def loss_fn(
    sched: MTPSchedule,
    coeffs: MTPCoeffs,
    data: Dataset,
    *,
    energy_weight: float = 1.0,
    force_weight: float = 0.01,
):
    """Weighted energy + force MSE (per-atom-normalized energies), a 0-d
    tensor. The forces are ``-dE/dx`` by autograd, kept in the graph when a
    coefficient requires grad, so the loss differentiates through them."""
    keep = any(t.requires_grad for t in _tensors(coeffs))
    with torch.enable_grad():
        pos = data.positions.detach().requires_grad_(True)
        e = _config_energies(sched, coeffs, data, pos)
        (grad,) = torch.autograd.grad(e.sum(), pos, create_graph=keep)
    if not keep:
        e = e.detach()
    r = data.real.to(e.dtype)
    n_real = torch.clamp(r.sum(1), min=1.0)
    de = (e - data.energies) / n_real
    le = de * de
    f_pred = -grad * r[..., None]
    lf = torch.sum((f_pred - data.forces * r[..., None]) ** 2, dim=(1, 2)) / n_real
    lf = torch.where(data.has_forces, lf, torch.zeros_like(lf))
    return energy_weight * torch.mean(le) + force_weight * torch.mean(lf)


def fit(
    sched: MTPSchedule,
    coeffs: MTPCoeffs,
    data: Dataset,
    *,
    steps: int = 300,
    learning_rate: float = 3e-3,
    energy_weight: float = 1.0,
    force_weight: float = 0.01,
    warm_start: bool = True,
    verbose_every: Optional[int] = None,
):
    """Fit all MTP coefficients with Adam (optional linear warm start).

    Returns (coeffs, losses): ``losses[k]`` is the loss of the coefficients
    step k starts from. The coefficients returned are those of the lowest
    loss among every step's starting point and the final coefficients
    (evaluated once more). The JAX ``fit`` keeps the coefficients one step
    after its best loss instead; on a falling curve both return the final
    ones.
    """
    if warm_start:
        coeffs = linear_warm_start(sched, coeffs, data)
    params = [t.detach().clone().requires_grad_(True) for t in _tensors(coeffs)]
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    kw = dict(energy_weight=energy_weight, force_weight=force_weight)

    losses = []
    best, best_loss = None, float("inf")
    for k in range(steps):
        opt.zero_grad()
        loss = loss_fn(sched, MTPCoeffs(*params), data, **kw)
        loss.backward()
        losses.append(float(loss.detach()))
        if losses[-1] < best_loss:
            best_loss, best = losses[-1], [p.detach().clone() for p in params]
        opt.step()
        if verbose_every and k % verbose_every == 0:
            print(f"step {k}: loss {losses[-1]:.3e}")
    final = MTPCoeffs(*(p.detach() for p in params))
    if best is None or float(loss_fn(sched, final, data, **kw)) < best_loss:
        return final, np.array(losses)
    return MTPCoeffs(*best), np.array(losses)


def training_set(teacher64, n_configs):
    """`n_configs` copies of the 108-atom fcc box (3x3x3, a = 4.0) displaced
    by 0.02-0.07 A (``tests/test_train.py``'s recipe, numpy seed 0), as
    ``Config``s labeled with energy and forces by `teacher64` (a float64
    ``MTPModel``) on the plain path, on its device. Not in the JAX module:
    the labeled set that the port's card check, profiler and tests share."""
    from mtp_tpu_torch.md.simulation import make_lattice
    from mtp_tpu_torch.models.mtp import mtp_energy_forces
    from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

    rng = np.random.default_rng(0)
    pos0, types, cell = make_lattice("fcc", 4.0, (3, 3, 3))
    dev = teacher64.device
    c = torch.as_tensor(cell, dtype=torch.float64, device=dev)
    t = torch.as_tensor(types, dtype=torch.int32, device=dev)
    out = []
    for k in range(n_configs):
        pos = pos0 + rng.normal(scale=0.02 + 0.01 * (k % 6), size=pos0.shape)
        p = torch.as_tensor(pos, dtype=torch.float64, device=dev)
        nl = build_neighbor_list(p, c, teacher64.cutoff, max_neighbors=64,
                                 grid=grid_shape(cell, teacher64.cutoff))
        if bool(nl.overflow):
            raise RuntimeError("training-set neighbor list overflow at J=64")
        r = mtp_energy_forces(teacher64, p, t, nl.idx, c, nl.mirror, compute_virial=False)
        out.append(Config(cell=cell, positions=pos, types=types, energy=float(r["energy"]),
                          forces=r["forces"].cpu().numpy()))
    return out
