"""Time one ``Model.prefill`` call of a benchmark cell's configuration at
given prompt lengths, on the card.

    python3 tools/prefill_host_time.py [--src <checkout>/src] \
        [--cell llava.chat] [--positions 1368 6727] [--calls 30] [--seed 1]

Builds the cell's configuration at full size with weights drawn from the
seed as the benchmark draws them, warms each length up, then times
``--calls`` calls a length, one prompt each: the host's time to return from
``prefill`` (its dispatch; it waits on the device only where the launch
queue fills) and its time to the end of the call's device work (a
synchronise).  Prints the medians as one JSON object.  ``--src`` imports
the port from another checkout, so that two trees are timed in one call to
the card (the harness's helpers come from this checkout).
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", default=os.path.join(ROOT, "src"))
    p.add_argument("--cell", default="llava.chat")
    p.add_argument("--positions", type=int, nargs="+", default=[1368, 6727])
    p.add_argument("--calls", type=int, default=30)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path[0:0] = [os.path.abspath(args.src), ROOT]

    import torch
    from repro_torch.models.api import build_model
    from servebench.core import spec
    from servebench.core.weights import make_batch, make_params
    if not torch.cuda.is_available():
        print("prefill_host_time: needs the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.cell)
    sizes = cell.numbers
    cfg = spec.port_config(cell.config)
    dtype = getattr(torch, cell.config["dtype"])
    model = build_model(cfg, impl=cell.config["impl"], device=device)
    params = make_params(model.param_defs(), args.seed, dtype, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = {"src": os.path.abspath(args.src),
           "device": torch.cuda.get_device_name(device), "calls": args.calls}
    with torch.inference_mode():
        for n in args.positions:
            batch = make_batch(gen, 1, n - cell.prefix, cell.prefix,
                               sizes["vocab_size"], sizes["d_model"], dtype,
                               device)
            for _ in range(3):
                model.prefill(params, batch)
            host, total = [], []
            for _ in range(args.calls):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                logits, cache = model.prefill(params, batch)
                t1 = time.perf_counter()
                torch.cuda.synchronize(device)
                host.append(t1 - t0)
                total.append(time.perf_counter() - t0)
                del logits, cache
            out[str(n)] = {"host_ms": 1e3 * statistics.median(host),
                           "device_end_ms": 1e3 * statistics.median(total)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
