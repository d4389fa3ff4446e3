"""The four user workflows of ``examples/`` on the port
(``mtp_tpu_torch.examples``): each ``main()`` on the CPU at a reduced size,
with the assertions it makes itself (the JAX examples' checks) and a few
on what it returns."""

import numpy as np

from mtp_tpu_torch.io.cfg_file import read_cfgs
from mtp_tpu_torch.io.mtp_file import load_mtp

from _torch_threads import _one_intra_op_thread  # noqa: F401 (autouse)


def test_full_workflow(tmp_path):
    from mtp_tpu_torch.examples.full_workflow import SELECT, main

    out = main(n_configs=4, fit_steps=5, md_steps=40, device="cpu", out_dir=tmp_path)
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    assert load_mtp(str(out["mtp"])).mvs is not None
    cfgs = read_cfgs(str(out["cfg"]))
    assert len(cfgs) == out["n_selected"]
    assert all(c.features["MV_grade"] >= SELECT and len(c.grades) == 108 for c in cfgs)


def test_lammps_migration(tmp_path):
    from mtp_tpu_torch.examples.lammps_migration import main

    out = main(n_steps=20, al_steps=20, device="cpu", out_dir=tmp_path)
    assert [r["step"] for r in out["thermo"]] == [10, 20]
    e = [r["etotal"] for r in out["thermo"]]
    assert abs(e[1] - e[0]) < 1e-4 * 54  # NVE in float64
    assert (tmp_path / "potassium.data").exists() and (tmp_path / "pre.cfg").exists()
    assert out["max_grade"] > 0


def test_multichip_md(tmp_path):
    from mtp_tpu_torch.examples.multichip_md import main

    ranks = main(n_ranks=2, reps=(8, 4, 4), nvt_steps=10, al_steps=5, device="cpu",
                 out_dir=tmp_path)
    assert [r["transport"] for r in ranks] == ["gloo", "gloo"]
    assert ranks[0]["frames"] == 2 and ranks[0]["max_grade"] > 0
    assert ranks[0]["energy"] == ranks[1]["energy"]  # replicated
    assert (tmp_path / "multichip_ckpt.npz").exists()
    assert (tmp_path / "multichip_traj.xyz").read_text().count("Lattice=") == 2


def test_accuracy_validation(tmp_path):
    from mtp_tpu_torch.examples.accuracy_validation import main

    out = main(reps=(4, 4, 4), n_steps=20, device="cpu", out_dir=tmp_path)
    assert out["atoms"] == 256 and 0 < out["max_df"] < 5e-5
