"""Which collectives the dry-run's steps plan on the installed torch version,
and how two dry-run sweeps (e.g. traced under two torch versions) differ.

    PYTHONPATH=src python3 tools/dryrun_compare.py plans OUT.json \
        [--arch zamba2-2.7b,whisper-medium,mamba2-130m]
    PYTHONPATH=src python3 tools/dryrun_compare.py compare DIR_A DIR_B

``plans`` traces each cell on both meshes as ``repro_torch.launch.dryrun``
does, with ``hlo_analysis.RedistributionLog`` on, and writes every cell's
redistributions (equal moves once each, with their number ``n`` and summed
collective bytes by kind).  ``compare`` reads the ``dryrun_<mesh>.json``
files of two ``python -m repro_torch.launch.dryrun --out DIR`` sweeps and
prints one JSON line a cell: the kinds whose collective bytes differ by
more than 1 % of the larger, the total collective bytes and
``t_collective`` of both.
"""
import argparse
import json
import pathlib

import torch


def group_moves(moves):
    """``RedistributionLog.moves`` with equal moves once each, beside their
    number ``n`` and their summed collective bytes."""
    groups = {}
    for m in moves:
        key = json.dumps({k: m[k] for k in ("src", "dst", "mesh", "shape",
                                            "dtype")})
        g = groups.setdefault(key, dict(json.loads(key), n=0, coll={}))
        g["n"] += 1
        for k, v in m["coll"].items():
            g["coll"][k] = g["coll"].get(k, 0) + v
    return list(groups.values())


def plans(archs, out: pathlib.Path) -> None:
    from repro_torch.configs import cells_for
    from repro_torch.launch.dryrun import fake_device_mesh, lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    rows = []
    for mesh_name in ("single", "multi"):
        shape = make_production_mesh(multi_pod=mesh_name == "multi")
        for arch in archs:
            for cell in cells_for(arch):
                moves = []
                with fake_device_mesh(shape) as mesh:
                    lower_cell(arch, cell, mesh, plans=moves)
                rows.append({"mesh": mesh_name, "arch": arch,
                             "cell": cell.name, "torch": torch.__version__,
                             "moves": group_moves(moves)})
                print(f"[{mesh_name}] {arch} {cell.name}: {len(moves)} "
                      "redistributions", flush=True)
    out.write_text(json.dumps(rows, indent=1))


def compare(a_dir: pathlib.Path, b_dir: pathlib.Path, rel: float = 0.01):
    """One row a cell of either sweep; ``"kinds"`` is None where a side
    lacks the cell or holds an error."""
    rows = []
    for mesh in ("single", "multi"):
        recs = []
        for d in (a_dir, b_dir):
            path = d / f"dryrun_{mesh}.json"
            recs.append({(r["arch"], r["cell"]): r for r in
                         json.loads(path.read_text())} if path.exists()
                        else {})
        a, b = recs
        for key in sorted(set(a) | set(b)):
            row = {"mesh": mesh, "arch": key[0], "cell": key[1],
                   "torch": [r.get(key, {}).get("torch") for r in recs]}
            if key not in a or key not in b or "error" in a[key] \
                    or "error" in b[key]:
                rows.append(dict(row, kinds=None))
                continue
            ca, cb = (r[key]["roofline"]["coll_breakdown"] for r in recs)
            row["kinds"] = {k: [ca[k], cb[k]] for k in ca
                            if abs(ca[k] - cb[k]) > rel * max(ca[k], cb[k])}
            row["coll_bytes"] = [sum(ca.values()), sum(cb.values())]
            row["t_collective"] = [r[key]["roofline"]["t_collective"]
                                   for r in recs]
            rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("plans")
    p.add_argument("out")
    p.add_argument("--arch", default="zamba2-2.7b,whisper-medium,"
                   "mamba2-130m")
    c = sub.add_parser("compare")
    c.add_argument("a_dir")
    c.add_argument("b_dir")
    args = ap.parse_args()
    if args.cmd == "plans":
        plans(args.arch.split(","), pathlib.Path(args.out))
    else:
        for row in compare(pathlib.Path(args.a_dir),
                           pathlib.Path(args.b_dir)):
            print(json.dumps(row))


if __name__ == "__main__":
    main()
