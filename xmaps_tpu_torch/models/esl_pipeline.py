"""ESLDepthEngine: ESL's depth (the evaluation's pseudo-ground truth) over
groups of scans.

The X-maps evaluation (``eval/x-map-eval.sh`` -> ``compute_depth_esl.py``)
computes ESL's depth for every scan of a sequence and keeps four planes a
scan: the init's disparity and depth, the refined depth and the refined
depth filtered.  This engine runs that pipeline over F scans in one call,
on one device:

1. stage: each scan normalised on the host (``apps.eval_esl.normalize_scan``)
   into one pinned buffer, then one host-to-device copy;
2. init, a scan at a time: kernel B into the camera's footprint box, kernel
   A, kernel B back (``apps.eval_esl.build_device_depth_init``), then the
   depth of the group's disparities at once (with ``fast_search=False``, or
   a projector surface whose rows are not monotone, the brute force
   ``depth_init_dense``);
3. refine: the (F, H, W) stack at once (``depth_optimization_dense``: one
   launch of kernel R on the card), each scan's empty pixels filled with
   1 / its pixel (0, 0) as the eval does;
4. denoise: the bilateral filter and the split-Bregman TV denoise over the
   stack (``utils.denoise``);
5. fetch: the planes into pinned host memory, then one synchronise.

Steps 3 and 4 issue the same launches whatever F is, and every scan of a
group is bit-equal to the one-scan calls of the same functions.  Each step
is a span of ``utils.stats`` inside ``esl.call`` (tagged with F).
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.apps.eval_esl import (
    RefinePlan,
    build_device_depth_init,
    depth_from_disparity,
    depth_init_dense,
    depth_optimization_dense,
    normalize_scan,
)
from xmaps_tpu_torch.calib.maps import CalibrationParams, CamProjMaps
from xmaps_tpu_torch.models.depth_pipeline import resolve_device
from xmaps_tpu_torch.ops.esl_search import rows_monotone
from xmaps_tpu_torch.utils.denoise import bilateral_filter, tv_denoise_split_bregman
from xmaps_tpu_torch.utils.stats import span

__all__ = ["ESLDepthEngine", "ESLPlanes", "BILATERAL", "TV_DENOISE", "GROUP_SCANS"]

#: scans a call is built for: the pinned staging buffer's size at set-up
#: (grown if a call brings more), and the size of ``apps.eval_esl``'s groups
GROUP_SCANS = 12

#: the bilateral filter's arguments (compute_depth_esl.py:242)
BILATERAL = dict(d=5, sigma_color=3.0, sigma_space=3.0)
#: the TV denoise's arguments (esl_utilities.py:206-223)
TV_DENOISE = dict(mu=0.5, eps=0.1, niter=20, niter_inner=10)


class ESLPlanes(NamedTuple):
    """A call's planes, each (F, H, W) float32 in the scans' order; the two
    refined planes are None where the call skipped the refinement."""

    disparity_init: torch.Tensor
    depth_init: torch.Tensor
    depth_optim: Optional[torch.Tensor]
    depth_optim_filtered: Optional[torch.Tensor]


class ESLDepthEngine:
    """ESL's depth pipeline bound to one calibration and one device; build
    with :meth:`from_calibration`, run with :meth:`process_scans`."""

    def __init__(self, maps: CamProjMaps, proj_rect: np.ndarray, plan: RefinePlan,
                 device: torch.device, depth_init, refine_iters: int):
        calib = maps.calib
        self.maps, self.proj_rect, self.plan = maps, proj_rect, plan
        self.p03 = float(maps.P2[0, 3])
        self.device = device
        #: ``build_device_depth_init``'s program, None for the brute force
        self.depth_init = depth_init
        self.refine_iters = int(refine_iters)
        self.shape = (calib.camera_height, calib.camera_width)
        self._host = self._host_buffer(GROUP_SCANS)
        #: the last host-to-device copy out of ``_host`` (CUDA only)
        self._copied = torch.cuda.Event() if device.type == "cuda" else None
        #: per-step wall-clock breakdown of the build, (label, seconds since
        #: the previous mark)
        self.setup_timings: list = []

    @property
    def fast_search(self) -> bool:
        """Whether the init runs kernels A and B (else the brute force)."""
        return self.depth_init is not None

    @staticmethod
    def from_calibration(
        calib: CalibrationParams,
        device,
        window_size: int = 7,
        refine_iters: int = 64,
        *,
        fast_search: bool = True,
        maps_cache_dir: Optional[str] = None,
    ) -> "ESLDepthEngine":
        """The engine of ``calib`` (an ESL rig: ``CalibrationParams.from_esl_yaml``'s
        rectified frame, 3x the projector) on ``device``, with the maps
        the evaluation uses (``CamProjMaps`` with the projector's
        distortion left out of its map), cached in ``maps_cache_dir``.
        Everything static is built once here, each step timed into
        ``setup_timings`` (on ``cuda`` each mark waits for the card first;
        ``XMAPS_SETUP_TRACE=1`` prints every mark to stderr): the footprint
        box, the two packed remap indices and the search's tables, the
        refinement's rays and constants on the device, and a pinned buffer for
        ``GROUP_SCANS`` scans."""
        trace = os.environ.get("XMAPS_SETUP_TRACE") == "1"
        t0 = time.perf_counter()
        timings: list = []
        prev = [t0]
        dev = resolve_device(device)

        def mark(label):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings.append((label, now - prev[0]))
            prev[0] = now
            if trace:
                print(f"[setup +{now - t0:7.2f}s] {label}", file=sys.stderr, flush=True)

        mark("device resolved (kernel library built or loaded)")
        maps = CamProjMaps.build_cached(calib, zero_undistort_proj_map=True,
                                        cache_dir=maps_cache_dir)
        mark("CamProjMaps (host calibration math, disk-cached)")
        # the analytic projector ramp, scanned downwards, rectified
        # (reference :96-101 + :201)
        proj_rect = maps.build_rectified_time_map(scan_upwards=False, border_replicate=False)
        mark("rectified projector time map")
        depth_init = None
        if fast_search and rows_monotone(proj_rect):
            depth_init = build_device_depth_init(maps, calib, proj_rect, float(maps.P2[0, 3]), dev)
        mark("init statics (footprint box, packed remap indices, search tables)")
        plan = RefinePlan(calib, maps, window_size, calib.projector_width,
                          calib.projector_height)
        plan.rays(dev)
        plan.constants(dev, refine_iters)
        mark("refinement plan (rays and kernel R's constants on the device)")
        eng = ESLDepthEngine(maps, proj_rect, plan, dev, depth_init, refine_iters)
        mark("pinned staging buffer")
        eng.setup_timings = timings
        return eng

    def _host_buffer(self, n: int) -> torch.Tensor:
        """A staging buffer for ``n`` scans: pinned for a CUDA engine."""
        return torch.empty((n, *self.shape), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _stage(self, scans) -> tuple:
        """(the normalised scans on the host, the same on the device)."""
        n = len(scans)
        if self._copied is not None:
            self._copied.synchronize()  # the previous copy out of the buffer is done
        if n > len(self._host):
            self._host = self._host_buffer(n)
        host = self._host[:n]
        rows = host.numpy()
        for f, scan in enumerate(scans):
            scan = np.asarray(scan)
            if scan.shape != self.shape:
                raise ValueError(f"scan {f} is {scan.shape}, the camera {self.shape}")
            if not scan.any():
                raise ValueError(f"scan {f} is empty: its normalisation needs a lit pixel")
            rows[f] = normalize_scan(scan)
        if self._copied is None:
            return host, host
        cam = torch.empty(host.shape, dtype=torch.float32, device=self.device)
        cam.copy_(host, non_blocking=True)
        self._copied.record(torch.cuda.current_stream(self.device))
        return host, cam

    def _init(self, host: torch.Tensor, cam: torch.Tensor) -> tuple:
        """(disparity, depth) of the group, (F, H, W) on the device."""
        if self.depth_init is not None:
            disp = torch.stack([self.depth_init.disparity(c) for c in cam])
            return disp, depth_from_disparity(disp, self.p03)
        pairs = [depth_init_dense(c, self.maps, self.proj_rect, self.p03, self.device)
                 for c in host.numpy()]
        return tuple(torch.from_numpy(np.stack(p)).to(self.device) for p in zip(*pairs))

    def _fetch(self, planes: list) -> list:
        """The planes in one pinned host block, after one synchronise (a
        CPU engine's are already on the host)."""
        if self.device.type != "cuda":
            return planes
        out = torch.empty((len(planes), *planes[0].shape), dtype=torch.float32,
                          pin_memory=True)
        for dst, src in zip(out, planes):
            dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return list(out)

    def process_scans(self, scans, *, refine: bool = True, fetch: bool = True) -> ESLPlanes:
        """ESL's planes of F scans: a (F, H, W) array or a sequence of
        (H, W) arrays, each a camera's time map with 0 where the scan never
        reached and at least one lit pixel (as the evaluation loads them
        from ``scans_np/*.npy``).  ``refine=False`` stops after the init.
        ``fetch``: the planes in pinned host memory, the call's one
        synchronise (else on the device, nothing waited for)."""
        n = len(scans)
        if n == 0:
            raise ValueError("process_scans: no scans")
        with span("esl.call", n):
            with span("esl.stage"):
                host, cam = self._stage(scans)
            with span("esl.init"):
                planes = list(self._init(host, cam))
            if refine:
                with span("esl.refine"):
                    # reference :211: each scan's zeros -> 1 / its pixel (0, 0)
                    corner = cam[:, 0, 0]
                    fill = torch.ones_like(corner) / corner
                    img = torch.where(cam == 0, fill[:, None, None], cam)
                    optim = depth_optimization_dense(planes[1], img, self.plan,
                                                     self.refine_iters)
                with span("esl.denoise"):
                    filtered = tv_denoise_split_bregman(bilateral_filter(optim, **BILATERAL),
                                                        **TV_DENOISE)
                planes += [optim, filtered]
            if fetch:
                with span("esl.fetch"):
                    planes = self._fetch(planes)
        return ESLPlanes(*planes, *[None] * (4 - len(planes)))
