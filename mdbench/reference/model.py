"""The MTP in plain PyTorch: the benchmark's reference.

Straight from the published model (Shapeev 2016; MLIP-3's ``pair_mtp``):

    E   = sum_i E_i,   E_i = c_{type i} + sum_s xi_s B_s(i)
    M_{mu,nu}(i) = sum_j f_mu(|r_ij|) (r_ij / |r_ij|)^{tensor nu}
    f_mu(d) = sum_k c^{type i, type j}_{mu,k} T_k(d)    (Chebyshev, enveloped)

The basic moments are the ``alpha_index_basic`` components; the other
moments are the products listed in ``alpha_index_times`` (a3 += mult * a0 *
a1), evaluated level by level; the ``alpha_moment_mapping`` moments are the
basis B_s. Forces and the virial come from ``torch.autograd`` of the total
energy with respect to every pair displacement; the candidate vectors of
active learning (dE_i / dtheta in MLIP-3's layout: radial block for the
atom's type, species one-hot, basis members) from the gradient with respect
to f_mu. It imports nothing of the program under test and is evaluated in
blocks of centers so that a box of 10^5 atoms fits.

The radial sum and the readout are matrix products, so a run with TF32
allowed computes them in TF32: the control that the comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench.reference.neighbors import PairList, pair_list


def _levels(times: np.ndarray, n_moments: int):
    """Rows of the product table grouped so that every row's inputs are
    complete before it runs: a node's level is one more than the highest
    level among the inputs of every row that writes it."""
    depth = np.zeros(n_moments, dtype=np.int64)
    while True:
        new = depth.copy()
        for a0, a1, _, a3 in times:
            new[a3] = max(new[a3], max(new[a0], new[a1]) + 1)
        if (new == depth).all():
            break
        depth = new
    lev = depth[times[:, 3]]
    return [times[lev == k] for k in range(1, int(depth.max()) + 1)] if len(times) else []


class ReferenceMTP:
    """The potential of one parsed ``.mtp`` (``parse_mtp``) on a device, in
    one dtype."""

    def __init__(self, pot: dict, device, dtype=torch.float64):
        self.pot = pot
        self.device, self.dtype = torch.device(device), dtype
        t = dict(device=self.device)
        self.S = pot["species_count"]
        self.RB = pot["radial_basis_size"]
        self.MU = pot["radial_funcs_count"]
        self.lo, self.hi, self.scaling = pot["min_dist"], pot["max_dist"], pot["scaling"]
        self.cutoff = self.hi
        basic = pot["alpha_index_basic"]
        self.B = len(basic)
        self.M = pot["alpha_moments_count"]
        self.mu = torch.as_tensor(basic[:, 0], **t)
        self.ax, self.ay, self.az = (torch.as_tensor(basic[:, k], **t) for k in (1, 2, 3))
        self.rank = int(basic[:, 1:].sum(axis=1).max())
        self.levels = [
            (torch.as_tensor(w[:, 0], **t), torch.as_tensor(w[:, 1], **t),
             torch.as_tensor(w[:, 2], dtype=dtype, **t), torch.as_tensor(w[:, 3], **t))
            for w in _levels(pot["alpha_index_times"], self.M)
        ]
        self.mapping = torch.as_tensor(pot["alpha_moment_mapping"], **t)
        # (S*S*RB, MU): row (a*S + b)*RB + k holds c^{ab}_{mu,k} for every mu
        rc = np.asarray(pot["radial_coeffs"]).transpose(0, 1, 3, 2).reshape(-1, self.MU)
        self.radial = torch.as_tensor(rc, dtype=dtype, **t)
        self.species = torch.as_tensor(pot["species_coeffs"], dtype=dtype, **t)
        self.moment = torch.as_tensor(pot["moment_coeffs"], dtype=dtype, **t)[:, None]
        self.n_coeffs = self.S * self.S * self.MU * self.RB + self.S + len(self.mapping)

    def chebyshev(self, d):
        """(P, RB) enveloped Chebyshev values."""
        ksi = (2.0 * d - (self.lo + self.hi)) / (self.hi - self.lo)
        vals = [self.scaling * (d - self.hi) ** 2]
        vals.append(ksi * vals[0])
        for _ in range(2, self.RB):
            vals.append(2.0 * ksi * vals[-1] - vals[-2])
        return torch.stack(vals, dim=-1)

    def _sites(self, disp, center, itype, jtype, n):
        """Site energies (n,) of `n` centers from their pairs, the basis (n,
        S_b), and the pairs' (f, cheb)."""
        d = torch.sqrt(torch.sum(disp * disp, dim=-1))
        u = disp / d[:, None]
        cheb = self.chebyshev(d)
        if self.S == 1:
            f = cheb @ self.radial
        else:
            pair = itype[center] * self.S + jtype
            onehot = torch.nn.functional.one_hot(pair, self.S * self.S).to(cheb.dtype)
            f = (onehot[:, :, None] * cheb[:, None, :]).reshape(len(d), -1) @ self.radial
        pw = [torch.ones_like(u)]
        for _ in range(self.rank):
            pw.append(pw[-1] * u)
        pw = torch.stack(pw, dim=1)  # (P, rank+1, 3)
        vals = f[:, self.mu] * pw[:, self.ax, 0] * pw[:, self.ay, 1] * pw[:, self.az, 2]
        basic = torch.zeros((n, self.B), dtype=disp.dtype, device=disp.device)
        basic = basic.index_add(0, center, vals)
        m = torch.cat([basic, basic.new_zeros((n, self.M - self.B))], dim=1)
        for a0, a1, mult, a3 in self.levels:
            m = m.index_add(1, a3, mult * m[:, a0] * m[:, a1])
        basis = m[:, self.mapping]
        e = self.species[itype] + (basis @ self.moment)[:, 0]
        return e, basis, (f, cheb)

    def evaluate(self, positions, types, cell, *, pairs: PairList | None = None,
                 virial: bool = False, candidates: bool = False, block: int = 8192,
                 energy_only: bool = False):
        """Energy, forces (N, 3), optionally the virial (Voigt xx, yy, zz,
        xy, xz, yz; W = -sum over pairs of sym(dE/dr (x) r)), the site
        energies and the candidate vectors (N, n_coeffs). `pairs` is a list
        built at the cutoff or beyond (pairs past the cutoff are dropped);
        None builds one."""
        pos = positions.detach().to(self.dtype)
        h = cell.detach().to(self.dtype)
        types = types.to(self.device).long()
        n_atoms = len(pos)
        if pairs is None:
            pairs = pair_list(pos, h, self.cutoff)
        disp_all = pairs.displacements(pos, h)
        live = torch.sum(disp_all * disp_all, dim=-1) <= self.cutoff ** 2
        pi, pj, disp_all = pairs.i[live], pairs.j[live], disp_all[live]
        bounds = torch.searchsorted(pi, torch.arange(0, n_atoms + block, block,
                                                     device=self.device)).tolist()
        forces = torch.zeros_like(pos)
        site = torch.zeros(n_atoms, dtype=self.dtype, device=self.device)
        w = torch.zeros(6, dtype=self.dtype, device=self.device)
        b_all = (torch.zeros((n_atoms, self.n_coeffs), dtype=self.dtype, device=self.device)
                 if candidates else None)
        for k, a in enumerate(range(0, n_atoms, block)):
            n = min(block, n_atoms - a)
            s0, s1 = bounds[k], bounds[k + 1]
            center = pi[s0:s1] - a
            itype, jtype = types[a:a + n], types[pj[s0:s1]]
            disp = disp_all[s0:s1].clone().requires_grad_(not energy_only)
            with torch.enable_grad():
                e, basis, (f, cheb) = self._sites(disp, center, itype, jtype, n)
                if not energy_only:
                    wrt = [disp, f] if candidates else [disp]
                    grads = torch.autograd.grad(e.sum(), wrt)
            site[a:a + n] = e.detach()
            if energy_only:
                continue
            g = grads[0]
            forces.index_add_(0, pi[s0:s1], g)
            forces.index_add_(0, pj[s0:s1], -g)
            if virial:
                r = disp.detach()
                w -= torch.stack([
                    torch.sum(g[:, 0] * r[:, 0]), torch.sum(g[:, 1] * r[:, 1]),
                    torch.sum(g[:, 2] * r[:, 2]),
                    0.5 * torch.sum(g[:, 0] * r[:, 1] + g[:, 1] * r[:, 0]),
                    0.5 * torch.sum(g[:, 0] * r[:, 2] + g[:, 2] * r[:, 0]),
                    0.5 * torch.sum(g[:, 1] * r[:, 2] + g[:, 2] * r[:, 1]),
                ])
            if candidates:
                b_all[a:a + n] = self._candidates(grads[1], cheb.detach(), center, itype,
                                                  jtype, basis.detach(), n)
        out = dict(energy=torch.sum(site), site=site, forces=forces, pairs=pairs)
        if virial:
            out["virial"] = w
        if candidates:
            out["b"] = b_all
        return out

    def _candidates(self, gf, cheb, center, itype, jtype, basis, n):
        """b = dE_i/dtheta: [radial (S, S, MU, RB) at row type i | species
        one-hot | basis]; dE_i/dc^{ab}_{mu,k} = sum over i's pairs with a
        type-b neighbor of dE/df_mu * T_k (E_i alone depends on i's pairs)."""
        S, MU, RB = self.S, self.MU, self.RB
        per = (gf[:, :, None] * cheb[:, None, :]).reshape(len(gf), MU * RB)
        rad = torch.zeros((n * S, MU * RB), dtype=gf.dtype, device=gf.device)
        rad = rad.index_add(0, center * S + jtype, per).reshape(n, S * MU * RB)
        onehot = torch.nn.functional.one_hot(itype, S).to(gf.dtype)
        b_rad = (onehot[:, :, None] * rad[:, None, :]).reshape(n, -1)
        return torch.cat([b_rad, onehot, basis], dim=1)
