"""Write the frozen captures that hold ofdm_tpu_torch to the JAX package's
bytes where no JAX is installed (a GPU host):

    python tests/gen_torch_fixtures.py

Run once on the CPU with x64.  It writes NEW files under tests/golden/ and
touches none that exist (tools/gen_golden.py owns those):

- ``torch_capture_qam256.dat`` + ``.npz``: 4 rows of QAM256 with guard bands
  and 8,192-byte payloads through the channel at SNR 55, rows 2-3 with CFO;
  every row must decode its payload exactly in JAX or the script fails;
- ``torch_capture_bpsk_gb.dat`` + ``.npz``: 4 rows of BPSK with guard bands
  and 1,024-byte payloads at SNR 20 with CFO; bit errors are allowed, the
  gate is equality with the bytes JAX decodes.

Each .dat is the rows back to back in the fc32 wire format (``write_iq``),
zero-padded to the ``decode_frame`` window plus one spare symbol.  Each npz
holds ``payloads`` [4, L], ``n_blocks``, ``row_len``, ``modulation``,
``decoded`` (``decode_frame``'s bytes for the samples as read back from the
file), row 0 through ``decode``: ``decode_payload``, ``decode_offset``, and
``jax_version``.  The CFO of every row is held below 0.6 pi / 80 so that no
per-sample angle of the reference estimator sits near its wrap.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import ofdm_tpu as ot
from ofdm_tpu.io.iqfile import read_iq, write_iq

OUT = os.path.join(os.path.dirname(__file__), "golden")
ROWS = 4
CFO_LIMIT = 0.6 * np.pi / 80

# name -> (modulation, payload bytes, SNR, (key, CFO?) per pair of rows,
#          every row must decode exactly)
CAPTURES = {
    "torch_capture_qam256": (ot.Modulation.QAM256, 8192, 55.0,
                             [(256, False), (257, True)], True),
    "torch_capture_bpsk_gb": (ot.Modulation.BPSK, 1024, 20.0,
                              [(30, True), (37, True)], False),
}


def gen(name, mod, payload_len, snr, halves, exact, seed):
    data = np.random.default_rng(seed).integers(0, 256, (ROWS, payload_len),
                                                dtype=np.uint8)
    tx = ot.encode(data, guard_bands=True, modulation=mod, dtype=jnp.complex64)
    rx = np.concatenate([
        np.asarray(ot.channel(tx[2 * i:2 * i + 2], snr=snr, timing_error=cfo,
                              key=jax.random.key(key)))
        for i, (key, cfo) in enumerate(halves)])
    nb = ot.n_data_blocks(payload_len, mod, True)
    row_len = ot.DEFAULT_CONFIG.sync_len + 80 + nb * 80
    rx = np.pad(rx, ((0, 0), (0, row_len - rx.shape[-1]))).astype(np.complex64)
    dat = os.path.join(OUT, f"{name}.dat")
    npz = os.path.join(OUT, f"{name}.npz")
    for path in (dat, npz):
        if os.path.exists(path):
            raise SystemExit(f"{path} exists; delete it to regenerate")
    write_iq(dat, rx.reshape(-1))
    back = read_iq(dat, dtype=np.complex64).reshape(ROWS, row_len)
    assert np.array_equal(back, rx)
    out = np.asarray(ot.decode_frame(jnp.asarray(back), n_blocks=nb,
                                     guard_bands=True, modulation=mod))
    good = (out[:, 16:16 + payload_len] == data).all(axis=1)
    errs = int(np.unpackbits(out[:, 16:16 + payload_len] ^ data).sum())
    if exact and not good.all():
        os.remove(dat)
        raise SystemExit(f"{name}: rows {np.flatnonzero(~good)} do not decode")
    cfos = []
    for row in back:
        _, diag = ot.decode(jnp.asarray(row), guard_bands=True, modulation=mod,
                            return_diagnostics=True)
        cfos.append(float(diag["f_delta"]))
    if max(cfos) > CFO_LIMIT:
        os.remove(dat)
        raise SystemExit(f"{name}: CFO {max(cfos):.5f} above {CFO_LIMIT:.5f}; "
                         "take other keys")
    pay0, diag0 = ot.decode(jnp.asarray(back[0]), guard_bands=True,
                            modulation=mod, return_diagnostics=True)
    np.savez_compressed(npz, payloads=data, decoded=out, n_blocks=np.int64(nb),
                        row_len=np.int64(row_len), modulation=mod.value,
                        decode_payload=np.asarray(pay0),
                        decode_offset=np.int64(diag0["offset"]),
                        jax_version=jax.__version__)
    print(f"wrote {dat} ({os.path.getsize(dat)} B) and {npz} "
          f"({os.path.getsize(npz)} B): {ROWS} rows of {row_len} samples, "
          f"{mod.value}, n_blocks {nb}, rows exact {int(good.sum())}/{ROWS}, "
          f"payload bit errors {errs}, f_delta {np.round(cfos, 5).tolist()}, "
          f"jax {jax.__version__}")


def main():
    for seed, (name, spec) in enumerate(CAPTURES.items()):
        gen(name, *spec, seed=1000 + seed)


if __name__ == "__main__":
    main()
