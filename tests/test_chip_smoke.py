"""The CPU-checkable parts of chip_smoke.py: it refuses any backend but
the GPU (JAX falls back to the CPU with only a warning), its last line
is the driver's JSON contract, and --devices takes 1 or 4."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("backend", ["cpu", "rocm", "METAL"])
def test_require_gpu_refuses_other_backends(backend):
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(backend)
    assert e.value.code not in (0, None)


def test_require_gpu_accepts_gpu():
    chip_smoke.require_gpu("gpu")


def test_main_on_cpu_exits_nonzero_without_result(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert "platform=cpu" in out


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


@pytest.mark.parametrize("argv,devices", [([], 1), (["--devices", "4"], 4),
                                          (["--devices", "1"], 1)])
def test_devices_option(argv, devices):
    assert chip_smoke.parse_args(argv).devices == devices


@pytest.mark.parametrize("argv", [["--devices", "2"], ["--devices", "x"]])
def test_devices_option_rejects_other_counts(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)
