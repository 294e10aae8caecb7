"""probe: accelerator discovery and diagnostics (port of
ofdm_tpu/apps/probe.py, the analogue of examples/probe.rs's USRP probe):
what ``torch.cuda`` knows of each card (name, compute capability, memory in
use and in all), then a 256 x 256 fp32 matmul smoke test with TF32 off.

    python -m ofdm_tpu_torch.apps.probe [--device cpu]

With ``--device cpu`` it reports the CPU and runs the matmul there; it never
falls back to the CPU by itself.
"""

from __future__ import annotations

import argparse

import torch

from ofdm_tpu_torch.apps.common import add_device_arg, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_device_arg(p)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"backend: {dev.type}")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        print(f"{n} device(s):")
        for i in range(n):
            props = torch.cuda.get_device_properties(i)
            free, total = torch.cuda.mem_get_info(i)
            print(f"  [{i}] {props.name} platform=cuda "
                  f"capability={props.major}.{props.minor} "
                  f"sms={props.multi_processor_count} "
                  f"hbm={(total - free) / 1e9:.2f}/{total / 1e9:.2f} GB")
    else:
        print(f"1 device(s):\n  [0] cpu platform=cpu "
              f"threads={torch.get_num_threads()}")
    x = torch.ones((256, 256), dtype=torch.float32, device=dev)
    y = x @ x
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not bool((y == 256.0).all()):
        print("matmul smoke test FAILED: ones(256, 256) @ ones(256, 256) != 256")
        return 1
    print("matmul smoke test: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
