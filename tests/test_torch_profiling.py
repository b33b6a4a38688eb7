# SPDX-License-Identifier: CECILL-2.1
"""``utils/profiling`` of the port beside the JAX package's: ``StageTimer``
totals and counts as ``tests/test_misc_api.py`` holds them, ``annotate``
nests and names its regions in a trace, ``device_trace`` writes a Chrome
trace file on the CPU, and ``create_perfetto_link=True`` is refused."""
import json
import logging
import time

import pytest
import torch

from barc4dip_tpu.utils import profiling as jprof
from barc4dip_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("prof", [tprof, jprof], ids=["torch", "jax"])
def test_stage_timer_accumulates(prof):
    timer = prof.StageTimer(sync=False)
    with timer.stage("a"):
        time.sleep(0.01)
    with timer.stage("a"):
        time.sleep(0.01)
    with timer.stage("b"):
        pass
    report = timer.report(log=False)
    assert report["a"] >= 0.02
    assert timer.counts == {"a": 2, "b": 1}
    assert set(report) == {"a", "b"} and report == timer.totals


def test_stage_timer_counts_a_stage_that_raises_and_logs_like_jax(caplog):
    lines = {}
    for prof in (tprof, jprof):
        timer = prof.StageTimer(sync=True)  # no card in use: nothing to wait for
        with pytest.raises(KeyError):
            with timer.stage("fails"):
                raise KeyError("x")
        with timer.stage("ok"):
            pass
        assert timer.counts == {"fails": 1, "ok": 1}
        timer.totals.update(fails=2.0, ok=1.0)
        with caplog.at_level(logging.INFO, logger=prof.logger.name):
            caplog.clear()
            timer.report()
        lines[prof] = [r.getMessage() for r in caplog.records]
    assert lines[tprof] == lines[jprof] and len(lines[tprof]) == 2
    assert lines[tprof][0].startswith("> stage fails")
    assert not torch.cuda.is_initialized()
    assert sorted(tprof.__all__) == sorted(jprof.__all__)


def test_annotate_nests_and_device_trace_writes_a_file(tmp_path):
    log_dir = tmp_path / "traces" / "run"
    with tprof.device_trace(str(log_dir)) as path:
        with tprof.annotate("outer-region"):
            with tprof.annotate("inner-region"):
                x = torch.ones(8, 8).sum()
            timer = tprof.StageTimer(sync=False)
            with timer.stage("timed-stage"):
                y = x * 2
    assert float(x) == 64.0 and float(y) == 128.0
    files = list(log_dir.iterdir())
    assert [str(f) for f in files] == [path] and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer-region", "inner-region", "timed-stage")}
    assert set(spans) == {"outer-region", "inner-region", "timed-stage"}
    outer, inner = spans["outer-region"], spans["inner-region"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert any("aten::" in e.get("name", "") for e in events)
    # a second trace goes to its own file
    with tprof.device_trace(str(log_dir)):
        torch.zeros(2).sum()
    assert len(list(log_dir.iterdir())) == 2


def test_device_trace_refuses_a_perfetto_link(tmp_path):
    with pytest.raises(ValueError, match="create_perfetto_link"):
        with tprof.device_trace(str(tmp_path / "t"), create_perfetto_link=True):
            pass
    assert not (tmp_path / "t").exists()
    with tprof.device_trace(str(tmp_path / "t"), create_perfetto_link=False):
        pass
    assert len(list((tmp_path / "t").iterdir())) == 1
