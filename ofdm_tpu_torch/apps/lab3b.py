"""lab3b: simulated loopback with carrier-frequency offset (port of
ofdm_tpu/apps/lab3b.py, which rebuilds examples/lab3b.rs: lab3a's pipeline
with timing_error on, exercising the Schmidl-Cox CFO path)."""

from __future__ import annotations

from ofdm_tpu_torch.apps import lab3a


def main(argv=None):
    argv = list(argv) if argv is not None else []
    if "--cfo" not in argv:
        argv.append("--cfo")
    return lab3a.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
