"""chip_smoke.py on the CPU: it refuses to report without a GPU or without
the package, and its phases run end to end on the stand-in at a test size
(on the card they run at 565,671 and 2,259,341 nodes)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, timeout=600, cwd=cwd)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu_or_package(tmp_path, alone):
    """No accelerator, or the script without the repository: non-zero exit
    and no JSON verdict."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = _run(str(tmp_path), str(script))
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_colwise_rel_groups():
    b = np.array([[1.0, 1e-12, 5.0], [2.0, -1e-12, 5.0]])
    a = b + np.array([[0.0, 1e-13, 0.0], [0.0, 0.0, 0.0]])
    assert cs.colwise_rel(a, b) == pytest.approx(0.1)
    # the tiny column compared at its group's scale
    assert cs.colwise_rel(a, b, [slice(0, 2)]) == pytest.approx(5e-14)


def test_state_groups_and_live_rows():
    from su2_tpu.state import Layout
    lay = Layout(2, 9)
    b = np.ones((3, lay.nvar))
    b[:, lay.RHOS + 4] = 1e-22            # a product absent to round-off
    a = b.copy()
    a[:, lay.RHOS + 4] = 0.0
    assert cs.colwise_rel(a, b) == pytest.approx(1.0)
    assert cs.colwise_rel(a, b, cs.state_groups(lay)) < 1e-21
    l64 = np.full((4, lay.nvar), -4.0)
    l64[:, lay.RHOS + 1] = -21.0          # product row: f32 round-off
    l64[:, lay.RHOS + 2] = -300.0         # no residual at all
    live = cs.live_rows(lay, l64)
    assert not live[lay.RHOS + 1] and not live[lay.RHOS + 2]
    assert live[lay.RHO] and live[lay.RHOS] and live[lay.RHOE]


def test_phase_node_state(standin_dir):
    lib_path = os.path.join(standin_dir, "library.txt")
    o32, inputs = cs.phase_node_f32(lib_path, 300, seed=0)
    assert o32["v"].dtype == np.float32 and o32["v"].shape[0] == 300
    cs.phase_node_f64(lib_path, o32, inputs)


def test_phase_main_writes_outputs(standin_dir, tmp_path):
    from su2_tpu import testcase
    case = str(tmp_path / "case")
    cfg = testcase.write_case(case, 33, 17, seed=0, niter=50)
    u, turb = cs.phase_main(case, cfg)
    assert u.shape == (33 * 17, 13) and turb.shape == (33 * 17, 2)


def test_phase_step_compare(standin_dir):
    cs.phase_step_compare(os.path.join(standin_dir, "case.cfg"), "CPU")


def test_phase_four_on_virtual_devices(tmp_path):
    """The four-card phase on four of the eight virtual CPU devices."""
    cs.phase_four(str(tmp_path), 0, "CPU", size=(33, 17))
