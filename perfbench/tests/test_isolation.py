"""Nothing the benchmark runs loads JAX or the JAX package ``sls_tpu``
(top-level names compared whole: ``sls_tpu_torch`` is the program), and
the plain reference imports nothing of the program."""

import ast
import subprocess
import sys

from perfbench.run import BENCH, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "sls_tpu")
PROGRAM_MODULES = ("sls_tpu_torch.convert", "sls_tpu_torch.models.detector",
                   "sls_tpu_torch.models.sls", "sls_tpu_torch.train.steps",
                   "sls_tpu_torch.train.loop", "sls_tpu_torch.data.pipeline",
                   "sls_tpu_torch.serve.engine", "sls_tpu_torch.evaluation.overlap")


def bench_modules():
    return sorted("perfbench." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
                  for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def loaded_after_import(modules):
    code = ("import importlib, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_command_loads_no_jax():
    names = loaded_after_import(bench_modules() + list(PROGRAM_MODULES))
    assert "sls_tpu_torch" in names and "perfbench" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    names = loaded_after_import(sorted(
        "perfbench.reference." + p.stem for p in (BENCH / "reference").glob("*.py")))
    assert not names & (set(FORBIDDEN) | {"sls_tpu_torch"})
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & (set(FORBIDDEN) | {"sls_tpu_torch"}), (path, tops)
            if "perfbench" in tops:
                assert node.module.startswith("perfbench.reference"), (path, node.module)


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "topk_sae.score_4s",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
