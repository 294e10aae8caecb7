"""Where ``encode`` and ``decode`` put host input.

Bytes, a bytearray or a numpy array go to CUDA unless the caller passes
``device=``; without CUDA that raises, naming ``device="cpu"``, instead of
carrying on on the CPU.  A tensor keeps its own device.  ``is_available``
is patched to False here, so the tests hold on a GPU host too.
"""

import numpy as np
import pytest
import torch

import ofdm_tpu_torch as ott
from ofdm_tpu_torch.ops.fft import set_full_fp32

torch.set_num_threads(1)

MOD = ott.Modulation.QPSK
PAYLOAD = bytes(range(40))
HOST_INPUTS = [PAYLOAD, bytearray(PAYLOAD), np.arange(40, dtype=np.uint8),
               list(range(40))]
HOST_IDS = ["bytes", "bytearray", "numpy", "list"]


def _encode(data, **kw):
    return ott.encode(data, guard_bands=True, modulation=MOD, **kw)


def _frame() -> torch.Tensor:
    """The frame of PAYLOAD, delayed by 7 samples, as a CPU tensor."""
    tx = _encode(torch.arange(40, dtype=torch.uint8))
    return torch.cat([torch.zeros(7, dtype=tx.dtype), tx])


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("data", HOST_INPUTS, ids=HOST_IDS)
def test_encode_host_input_on_the_cpu_when_asked(data):
    got = _encode(data, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, _encode(torch.arange(40, dtype=torch.uint8)))


def test_decode_numpy_on_the_cpu_when_asked():
    rx = _frame()
    got = ott.decode(rx.numpy(), guard_bands=True, modulation=MOD, device="cpu")
    np.testing.assert_array_equal(got, ott.decode(rx, guard_bands=True,
                                                  modulation=MOD))
    np.testing.assert_array_equal(got, np.arange(40, dtype=np.uint8))


@pytest.mark.parametrize("call", [
    lambda: _encode(PAYLOAD),
    lambda: _encode(np.arange(40, dtype=np.uint8)),
    lambda: ott.decode(_frame().numpy(), guard_bands=True, modulation=MOD),
    lambda: _encode(torch.arange(40, dtype=torch.uint8), device="cuda"),
], ids=["encode bytes", "encode numpy", "decode numpy", "tensor to cuda"])
def test_cuda_without_cuda_raises(no_cuda, call):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_a_tensor_keeps_its_device(no_cuda):
    tx = _encode(torch.arange(40, dtype=torch.uint8))
    assert tx.device.type == "cpu"
    got = ott.decode(_frame(), guard_bands=True, modulation=MOD)
    np.testing.assert_array_equal(got, np.arange(40, dtype=np.uint8))


@pytest.mark.gpu
def test_host_input_goes_to_cuda_by_default():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_full_fp32()
    tx = _encode(PAYLOAD)
    assert tx.device.type == "cuda"
    rx = torch.cat([torch.zeros(7, dtype=tx.dtype, device=tx.device), tx])
    got = ott.decode(rx.cpu().numpy(), guard_bands=True, modulation=MOD)
    np.testing.assert_array_equal(got, np.arange(40, dtype=np.uint8))
