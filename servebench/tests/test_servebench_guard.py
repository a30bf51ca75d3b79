"""Nothing the benchmark runs loads JAX or the JAX package, and nothing in
servebench/reference loads the program; names are compared whole by their
top-level part."""
import subprocess
import sys
import textwrap

from servebench.core import guard, spec


def test_names_are_compared_whole_by_their_top_level_part():
    assert guard.loaded({"repro_torch": 1, "repro_torch.models.api": 1,
                         "jaxtyping": 1, "reproduce": 1}) == []
    assert guard.loaded({"repro.models": 1, "jax.numpy": 1,
                         "flax.linen": 1}) == ["flax", "jax", "repro"]


def test_the_references_import_neither_the_program_nor_jax():
    assert guard.reference_violations(spec.ROOT) == []


def test_a_reference_that_imports_the_program_is_found(tmp_path):
    ref = tmp_path / "servebench" / "reference"
    ref.mkdir(parents=True)
    (ref / "bad.py").write_text("import torch\nfrom repro_torch.models "
                                "import api\nimport jax.numpy as jnp\n")
    assert guard.reference_violations(tmp_path) == ["bad.py: jax",
                                                    "bad.py: repro_torch"]


def test_a_fresh_interpreter_running_the_benchmark_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path[0:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / "src")!r}]
        import json
        from servebench.core import cli, control, guard, spec
        import repro_torch.models.api
        bench = json.load(open(spec.ROOT / "BENCHMARK.json"))
        for w in bench["workloads"]:
            spec.load_cell(w["name"]).reference()
        for m in bench["per_layer"]:
            spec.load_reader(m["name"])
        print(guard.loaded())
        """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
