#!/usr/bin/env python3
"""Time alloc_active_set's warp route at chosen geometries on the GPU.

    python3 tools/alloc_sweep.py

The geometry the launcher takes (``alloc_active_set_geometry``) against a
few others at chip_smoke.py's timed shape, to show what sets the kernel's
time: fewer warps an SM, fewer stages, and plain loads in place of the bulk
copies (``stages = 0``).  Each geometry is launched through the library's
C entry point, checked against ``ref.alloc_active_set_ref`` (rtol 1e-4,
atol capacity * 1e-5, ``feasible`` equal) and timed as chip_smoke.py times
kernels (CUDA events; device µs by torch.profiler).  One JSON line each,
then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.alloc_active_set import (  # noqa: E402
    ROUTES, alloc_active_set_geometry)

# (rows, stages, ctas, warps) at (16384, 128), beside the launcher's own:
# two stages, plain loads, 4 warps a CTA (16 an SM), 3 and 2 CTAs an SM
SWEEP = ((8, 2, 528, 8), (8, 0, 528, 8), (4, 3, 528, 4), (8, 3, 396, 8),
         (8, 3, 264, 8))


def run(d, rows, stages, ctas, warps):
    psi, omega, floors, cap, mask = d
    N, S = psi.shape
    al = torch.empty((N, S), dtype=torch.float32, device=cs.DEV)
    fe = torch.empty(N, dtype=torch.bool, device=cs.DEV)
    pin = torch.empty((N, S), dtype=torch.bool, device=cs.DEV)
    args = (psi.data_ptr(), omega.data_ptr(), floors.data_ptr(),
            cap.data_ptr(), mask.data_ptr(), al.data_ptr(), fe.data_ptr(),
            pin.data_ptr(), N, S, ROUTES["warp"], rows, stages, ctas, warps,
            _build.current_stream(cs.DEV))

    def launch():
        _build.launch("alloc_active_set", *args)
    launch()
    r_al, r_fe, _ = ref.alloc_active_set_ref(*d)
    torch.cuda.synchronize()
    ok = torch.equal(fe, r_fe) and bool(
        ((al - r_al).abs() <= 1e-4 * r_al.abs() + 1e-5 * cap[:, None]).all())
    if not ok:
        raise AssertionError(f"geometry {(rows, stages, ctas, warps)} at "
                             f"{(N, S)}: outside the tolerance")
    us, _ = cs.profiled(launch, ("alloc_warp_kernel",))
    return {"shape": [N, S], "geometry": [rows, stages, ctas, warps],
            "event_us": cs.median_ms(launch) * 1e3,
            "device_us": us["alloc_warp_kernel"]}


def main() -> None:
    _build.build_all()
    _build.load()
    for kind, N, S, extra in (("yardstick", 16384, 128, SWEEP),
                              ("feasible", 16384, 128, SWEEP[1:2]),
                              ("yardstick", 2048, 128, ())):
        g = alloc_active_set_geometry(N, S, cs.SMS)
        d = cs.alloc_dev(2, N, S, kind)
        for geom in ((g.rows, g.stages, g.ctas, g.warps),) + extra:
            print(json.dumps({"kind": kind, "launcher": geom == tuple(g[1:]),
                              **run(d, *geom)}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
