"""obs/profiler.py of the port: ``trace`` writes a chrome trace that names
the enclosed work, ``timed`` and ``annotate`` run without a card, with the
JAX package's names and context-manager use."""

import contextlib
import inspect
import json
import logging

import torch

import ofdm_tpu_torch as ott
from ofdm_tpu.obs import profiler as jprofiler
from ofdm_tpu_torch.obs import profiler

torch.set_num_threads(1)


def _decode_step():
    tx = ott.encode(bytes(range(64)), guard_bands=True,
                    modulation=ott.Modulation.QPSK, device="cpu")
    return ott.decode_frame(tx, n_blocks=ott.n_data_blocks(
        64, ott.Modulation.QPSK, True), guard_bands=True,
        modulation=ott.Modulation.QPSK)


def test_same_interface_as_the_jax_package():
    for name in ("trace", "timed", "annotate"):
        mine, theirs = getattr(profiler, name), getattr(jprofiler, name)
        assert list(inspect.signature(mine).parameters) == \
            list(inspect.signature(theirs).parameters), name
        assert isinstance(mine("x"), contextlib.AbstractContextManager)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiler.trace(str(log_dir)) as where:
        assert where == str(log_dir)
        with profiler.annotate("decode_step"):
            out = _decode_step()
    assert out.dtype == torch.uint8
    path = log_dir / profiler.TRACE_NAME
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "decode_step" in names                  # the annotation
    assert any(n and "aten::" in n for n in names)   # and the work inside it


def test_trace_is_written_when_the_block_raises(tmp_path):
    try:
        with profiler.trace(str(tmp_path)):
            raise KeyError("boom")
    except KeyError:
        pass
    else:
        raise AssertionError("the block's exception must propagate")


def test_timed_logs_a_span(caplog):
    assert not torch.cuda.is_initialized()
    with caplog.at_level(logging.DEBUG, logger="ofdm_tpu_torch.profiler"):
        with profiler.timed("step"):
            _decode_step()
    assert not torch.cuda.is_initialized()          # no card was touched
    [rec] = [r for r in caplog.records if r.name == "ofdm_tpu_torch.profiler"]
    assert rec.getMessage().startswith("step: ") and rec.getMessage().endswith(" ms")


def test_annotate_outside_a_trace_is_harmless():
    with profiler.annotate("nothing recording"):
        assert _decode_step().shape[0] > 0
