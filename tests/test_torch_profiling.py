"""The launchers' profile summary: the device's work counted once."""
from types import SimpleNamespace

import torch

from repro_torch.launch import profiling

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, *, device=CUDA, stream=7, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, device_index=0,
        device_resource_id=stream, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end))


def test_device_events_drop_annotations_duplicates_and_host_events():
    events = [_ev("k1", 0, 100), _ev("k1", 0, 100),  # listed twice
              _ev("k2", 150, 250), _ev("k2", 150, 250, stream=8),
              _ev("range", 0, 400, annotation=True),
              _ev("aten::mm", 0, 500, device=CPU)]
    kept, counts = profiling.device_events(events)
    assert [(e.name, e.device_resource_id) for e in kept] == [
        ("k1", 7), ("k2", 7), ("k2", 8)]
    assert counts == dict(device_events=5, annotations=1, duplicates=1)
    # the union counts the two overlapping k2 once, and not the annotation
    assert profiling.busy_ms(kept) == 0.2


def test_print_profile_on_a_host_trace(capsys):
    with torch.profiler.profile(
            activities=profiling.activities(torch.device("cpu"))) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    profiling.print_profile(prof, 0.5)
    out = capsys.readouterr().out
    assert "0 device events on 0 streams" in out
    assert "busy share 0.000" in out
