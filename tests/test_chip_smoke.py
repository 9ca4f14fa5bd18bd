"""chip_smoke.py on the CPU: it must refuse to report success without a
GPU, its CSV comparator must catch a single byte, and its phase-B
parity harness must hold at toy size."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_gpu(tmp_path, where):
    """No accelerator (or no program beside the script): non-zero exit
    and no success line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert not (script.parent / ".smoke_work").exists()


@pytest.mark.parametrize("got,want,where", [
    (b"h\nr1,150,0.5,T1\n", b"h\nr1,150,0.5,T1\n", None),
    (b"h\nr1,150,0.5,T1\n", b"h\nr1,150,0.6,T1\n", "line 2, byte 10"),
    (b"h\nr1,150,0.5,T1\n", b"h\nr1,150,0.5,T1\nr2,1,0,NA\n",
     "line 3, byte 1"),
    (b"h\nr1,150,0.5,T1\n", b"h\nr1,150,0.5,T1", "length differs"),
], ids=["equal", "one_byte", "missing_row", "missing_newline"])
def test_compare_csv(got, want, where):
    diff = chip_smoke.compare_csv(got, want)
    if where is None:
        assert diff is None
    else:
        assert diff is not None and diff.startswith(where), diff
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.require_same("t", got, want)


@pytest.mark.parametrize("stderr,parts", [
    (" - Backend: gpu (H100) x 1\n", 1),
    (" - Streaming DB in 8 bucket-range parts (--max-table-mb 2)\n", 8),
])
def test_stream_parts_of(stderr, parts):
    assert chip_smoke.stream_parts_of(stderr) == parts


def test_phase_b_toy_matches_oracle_and_cpu_child(tmp_path):
    """Phase B at toy size: both databases, all four classify modes,
    every CSV byte-identical to the oracle and to the CPU child."""
    assert chip_smoke.phase_b(tmp_path, n_targets=3, glen=3000,
                              n_reads=40) == 8


def test_make_reads_skip_k_minus_one_lengths():
    single, paired = chip_smoke.make_reads(["ACGT" * 200] * 2, 300, seed=3)
    lengths = {len(s) for _, s in single}
    assert not lengths & {26, 30}
    assert len(paired) == 300
    assert all(a.endswith("/1") and b.endswith("/2")
               for a, b, _, _ in paired)
