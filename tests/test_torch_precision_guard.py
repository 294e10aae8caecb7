"""The full-fp32 guard under each way of setting PyTorch's TF32 flags.

``require_full_fp32`` only reads flags, so it is called here with
``torch.device("cuda")`` on a host without a card.  Each case runs in a
process of its own: the flags are process-wide, and PyTorch remembers which
of its two interfaces (the legacy ``allow_tf32`` flags, the
``fp32_precision`` settings) a process has used.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

PRELUDE = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
from ofdm_tpu_torch.ops.fft import require_full_fp32, set_full_fp32
matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
"""

CHECK = """
try:
    require_full_fp32(torch.device("cuda"))
    print("passes")
except RuntimeError as e:
    assert "ofdm_tpu_torch needs full-fp32" in str(e), e
    assert "mix of the legacy" not in str(e).split("PyTorch could not")[0], e
    print("raises:", e)
require_full_fp32(torch.device("cpu"))          # the CPU is never refused
"""

NEW_API = hasattr(torch.backends.cuda.matmul, "fp32_precision")

# name -> (what the process sets, does the guard pass, needs fp32_precision)
CASES = {
    "defaults": ("", False, False),
    "legacy flags off":
        ("matmul.allow_tf32 = False; cudnn.allow_tf32 = False", True, False),
    "legacy matmul on":
        ("matmul.allow_tf32 = True; cudnn.allow_tf32 = False", False, False),
    "legacy cudnn left on": ("matmul.allow_tf32 = False", False, False),
    "new api ieee":
        ('matmul.fp32_precision = "ieee"; cudnn.conv.fp32_precision = "ieee"',
         True, True),
    "new api global ieee": ('torch.backends.fp32_precision = "ieee"', True, True),
    "new api cudnn ieee, conv unset":
        ('matmul.fp32_precision = "ieee"; cudnn.fp32_precision = "ieee"; '
         'cudnn.conv.fp32_precision = "none"', True, True),
    "new api tf32":
        ('matmul.fp32_precision = "tf32"; cudnn.conv.fp32_precision = "tf32"',
         False, True),
    "new api matmul only": ('matmul.fp32_precision = "ieee"', False, True),
    "the helper": ("set_full_fp32()", True, False),
    "mixed, all off":
        ('matmul.allow_tf32 = False; cudnn.conv.fp32_precision = "ieee"',
         True, True),
    "mixed, conv on":
        ('matmul.fp32_precision = "ieee"; cudnn.allow_tf32 = True', False, True),
    "mixed, matmul on":
        ('cudnn.conv.fp32_precision = "ieee"; matmul.allow_tf32 = True',
         False, True),
}


def _run(setting: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", PRELUDE + setting + "\n" + CHECK, str(ROOT)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


@pytest.mark.parametrize("name", CASES)
def test_guard(name):
    setting, passes, needs_new = CASES[name]
    if needs_new and not NEW_API:
        pytest.skip("this PyTorch has no fp32_precision settings")
    out = _run(setting)
    if passes:
        assert out == "passes", out
    else:
        assert out.startswith("raises:"), out
        # the error names both ways of turning TF32 off
        assert "fp32_precision" in out and "allow_tf32" in out
        assert "set_full_fp32" in out


def test_helper_writes_one_interface_only():
    """After the helper, PyTorch's own legacy read still refuses on a
    PyTorch with both interfaces (fault F9's trigger), and the guard, which
    reads the new one only, passes."""
    if not NEW_API:
        pytest.skip("this PyTorch has no fp32_precision settings")
    out = _run("""
set_full_fp32()
assert matmul.fp32_precision == "ieee" and cudnn.conv.fp32_precision == "ieee"
try:
    cudnn.allow_tf32
    print("legacy read allowed")
except RuntimeError:
    print("legacy read refused by PyTorch")
""")
    assert out.splitlines()[-1] == "passes", out


def test_error_text_names_what_it_found():
    if not NEW_API:
        pytest.skip("this PyTorch has no fp32_precision settings")
    out = _run('matmul.fp32_precision = "tf32"; cudnn.conv.fp32_precision = "ieee"')
    assert "torch.backends.cuda.matmul.fp32_precision = 'tf32'" in out
    assert "cudnn.conv" not in out.split("found")[1]


def test_decode_on_a_cuda_tensor_asks_the_guard(monkeypatch):
    """The entry points call the guard with the input's device."""
    import ofdm_tpu_torch as ott
    from ofdm_tpu_torch.phy import rx
    seen = []
    monkeypatch.setattr(rx, "require_full_fp32", lambda dev: seen.append(dev.type))
    tx = ott.encode(bytes(range(40)), guard_bands=True,
                    modulation=ott.Modulation.QPSK, device="cpu")
    ott.decode(tx, guard_bands=True, modulation=ott.Modulation.QPSK)
    ott.decode_frame(tx, n_blocks=5, guard_bands=True,
                     modulation=ott.Modulation.QPSK)
    assert seen == ["cpu", "cpu"]
