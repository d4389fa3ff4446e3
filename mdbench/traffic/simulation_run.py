"""Traffic driver: ``Simulation.run``, the entry the program's users call.

Each call of the window runs ``blocks_per_call`` blocks of the
Simulation's ``steps_per_rebuild`` steps: per block one neighbor rebuild,
the steps, and one host read of the block's flags with the program's own
recovery (a tripped block is discarded and retried with a wider list or a
shorter block). The observer stamps every accepted block. The ensemble and
its parameters come from the traffic file.
"""

from __future__ import annotations

from mdbench.program import Program


class Driver(Program):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.instrument()
        self.watch_retries("block")

    def attempts(self) -> int:
        return self.counts.get("Simulation.block", 0)

    def call(self):
        start, first = self.state, []

        def observer(state):
            with self.span("observer"):
                self.observe()
                if not first:
                    first.append(state)

        n = self.sim.steps_per_rebuild * self.traffic["blocks_per_call"]
        with self.span("Simulation.run"):
            self.state, self.aux = self.sim.run(self.state, n, aux=self.aux,
                                                observer=observer, **self.kw)
        self.keep_sample(start, first[0])
