"""Traffic driver: ``run_with_extrapolation``, MD graded as it runs.

The potential carries an active set (MVS) that the program builds in
set-up from the traffic's perturbed boxes: the program's float64 candidate
vectors, its MaxVol selection, written into the ``.mtp`` file and loaded
back through ``MTPModel.load``, as a user's ``select-add`` round would. The
monitor works in MLIP-3 style: every segment of ``al_every`` steps is
graded, and a configuration whose grade reaches ``select_threshold`` is
appended to a ``.cfg`` stream in the run's temporary directory. There is no
break threshold: a break would end the window. Each call runs
``segments_per_call`` segments; the observer stamps every accepted one.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench.program import Program


class Driver(Program):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        from mtp_tpu_torch.al.driver import ExtrapolationMonitor

        self.selected = 0
        self.max_grades = []
        self.monitor = ExtrapolationMonitor(
            self.model, select_threshold=self.traffic["select_threshold"],
            output_path=str(self.workdir / "selected.cfg"),
            max_neighbors=self.config["max_neighbors"],
        )
        self.instrument()
        self.watch_retries("run_async")

    def load_model(self):
        from mtp_tpu_torch.al.grades import candidate_vectors
        from mtp_tpu_torch.al.maxvol import build_mvs
        from mtp_tpu_torch.io.mtp_file import load_mtp, save_mtp
        from mtp_tpu_torch.models.mtp import MTPModel
        from mtp_tpu_torch.ops.neighbors import build_neighbor_list, grid_shape

        path = self.potential_path()
        m64 = MTPModel.load(str(path), device=self.device, dtype=torch.float64)
        rows = []
        for pos, cell, types in self.inputs.mvs_boxes:
            p = torch.as_tensor(pos, device=self.device)
            c = torch.as_tensor(cell, device=self.device)
            nl = build_neighbor_list(p, c, m64.cutoff, max_neighbors=self.config["max_neighbors"],
                                     grid=grid_shape(cell, m64.cutoff))
            if bool(nl.overflow):
                raise RuntimeError("an active-set box overflowed its neighbor list")
            t = torch.as_tensor(types, device=self.device)
            rows.append(candidate_vectors(m64, p, t, nl.idx, c)[0].cpu().numpy())
        data = load_mtp(str(path))
        data.mvs = build_mvs(np.concatenate(rows), mode=self.traffic["active_set"]["mode"])
        al_path = self.workdir / "potential_mvs.mtp"
        save_mtp(str(al_path), data)
        return MTPModel.load(str(al_path), device=self.device, dtype=torch.float32)

    def attempts(self) -> int:
        return self.counts.get("Simulation.run_async", 0)

    def call(self):
        from mtp_tpu_torch.al.driver import run_with_extrapolation

        start, first = self.state, []
        threshold = self.traffic["select_threshold"]

        def observer(state, monitor):
            with self.span("observer"):
                self.observe()
                self.max_grades.append(monitor.max_grade)
                self.selected += monitor.max_grade >= threshold
                if not first:
                    first.append(state)

        n = self.traffic["al_every"] * self.traffic["segments_per_call"]
        with self.span("run_with_extrapolation"):
            self.state = run_with_extrapolation(self.sim, self.monitor, self.state, n,
                                                al_every=self.traffic["al_every"],
                                                observer=observer, **self.kw)
        self.keep_sample(start, first[0])

    def reset_counts(self):
        super().reset_counts()
        self.selected, self.max_grades = 0, []

    def grades(self):
        """The last grade step's per-atom grades (user order) and state."""
        return np.asarray(self.monitor.nbh_grades, dtype=np.float64)

    def cfg_bytes(self) -> int:
        """Bytes of the selected configurations' stream so far."""
        if self.monitor._writer is not None:
            self.monitor._writer.flush()
        path = self.workdir / "selected.cfg"
        return path.stat().st_size if path.exists() else 0

    def release(self):
        self.monitor.close()
        self.monitor = None
        super().release()
