"""Group staging (``XMapsDepthEngine.stage_group`` -> ``io/prefetch.py``
``stage_compact_group``): host us of staging a frame, over the window."""


def read(run):
    d = run.durations("engine.stage_group")
    frames = run.values.get("frames")
    return sum(d) / frames * 1e6 if d and frames else None
