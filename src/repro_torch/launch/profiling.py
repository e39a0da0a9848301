"""What the launchers' ``--profile`` prints: the device busy share of a
torch.profiler trace and its kernels by device time."""
from __future__ import annotations

from collections import defaultdict

import torch


def activities(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def device_events(events):
    """The device's work among a trace's events, each activity once.

    A user annotation that the trace projects onto the device's timeline
    spans kernels and the gaps between them, so it is not device work and
    is left out; an event listed twice (same name, device, stream, start
    and end) is kept once.  Returns (events, counts of what was seen and
    left out)."""
    seen, out = set(), []
    counts = dict(device_events=0, annotations=0, duplicates=0)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        counts["device_events"] += 1
        if e.is_user_annotation:
            counts["annotations"] += 1
            continue
        key = (e.name, e.device_index, e.device_resource_id,
               e.time_range.start, e.time_range.end)
        if key in seen:
            counts["duplicates"] += 1
            continue
        seen.add(key)
        out.append(e)
    return out, counts


def busy_ms(events):
    """Time the device ran any of ``events`` (ms): the union of their
    intervals, so events that overlap count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return busy_us / 1e3


def print_profile(prof, wall_s, top=12):
    """Busy share of the traced run (busy time over wall time), the device
    events left out, and the kernels by summed device time."""
    events, counts = device_events(prof.events())
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        row = by_name[e.name]
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    summed = sum(us for us, _ in by_name.values()) / 1e3
    busy = busy_ms(events)
    streams = len({(e.device_index, e.device_resource_id) for e in events})
    print(f"profile: wall {wall_s * 1e3:.1f} ms, {len(events)} device "
          f"events on {streams} streams (of {counts['device_events']}: "
          f"{counts['annotations']} annotations and {counts['duplicates']} "
          f"duplicates left out), kernel time summed {summed:.1f} ms, device "
          f"busy {busy:.1f} ms, busy share {busy / 1e3 / wall_s:.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in ranked[:top]:
        print(f"  {us / 1e3:9.2f} ms {n:7d}x {name[:90]}")
