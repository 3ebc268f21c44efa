"""The port stands alone: no JAX, flax, optax or sls_tpu in it, nor
pandas, sklearn or msgpack (the card's machine has none of them), and
its entry points run on the card unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "sls_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

# the long-clip evaluation slice's modules: the import checks below must
# cover them
LONG_CLIP_MODULES = ("sls_tpu_torch.kernels.attention", "sls_tpu_torch.evaluation.overlap",
                     "sls_tpu_torch.metrics.eer", "sls_tpu_torch.analysis.temporal")

# the multi-process slices' modules (scoring; data- and tensor-parallel training)
PARALLEL_MODULES = ("sls_tpu_torch.parallel.distributed", "sls_tpu_torch.parallel.mesh",
                    "sls_tpu_torch.parallel.sequence", "sls_tpu_torch.parallel.launch",
                    "sls_tpu_torch.parallel.workers", "sls_tpu_torch.parallel.tensor")

# the offline evaluation slice's modules
OFFLINE_MODULES = ("sls_tpu_torch.data.audio", "sls_tpu_torch.data.flac",
                   "sls_tpu_torch.data.protocols", "sls_tpu_torch.data.mulaw",
                   "sls_tpu_torch.data.pipeline", "sls_tpu_torch.metrics.eer",
                   "sls_tpu_torch.scores.evaluate", "sls_tpu_torch.scores.standalone",
                   "sls_tpu_torch.convert", "sls_tpu_torch.ckpt.msgpack",
                   "sls_tpu_torch.ckpt.checkpoint", "sls_tpu_torch.train.loop",
                   "sls_tpu_torch.serve.scorer")

# the SLS family's and the rest of the SAE family's modules
FAMILY_MODULES = ("sls_tpu_torch.sae.cpc", "sls_tpu_torch.sae.legacy",
                  "sls_tpu_torch.sae.geometry", "sls_tpu_torch.heads.sls",
                  "sls_tpu_torch.models.sls", "sls_tpu_torch.analysis.sparsity")

# the entry points' modules: the command lines, the HTTP server, the
# deployment artifact, profiling, and the kernels' custom ops
ENTRY_MODULES = ("sls_tpu_torch.cli.main", "sls_tpu_torch.cli.serve",
                 "sls_tpu_torch.cli.export", "sls_tpu_torch.cli.profile_diff",
                 "sls_tpu_torch.cli.monitor", "sls_tpu_torch.cli.package_results",
                 "sls_tpu_torch.serve.server", "sls_tpu_torch.serve.export",
                 "sls_tpu_torch.train.profiling", "sls_tpu_torch.kernels.ops")

# the analysis path: the analysis modules, their command line and the report
ANALYSIS_MODULES = ("sls_tpu_torch.analysis.temporal", "sls_tpu_torch.analysis.dsp",
                    "sls_tpu_torch.analysis.importance", "sls_tpu_torch.analysis.score_explainer",
                    "sls_tpu_torch.analysis.probes", "sls_tpu_torch.analysis.failure_modes",
                    "sls_tpu_torch.analysis.attribution", "sls_tpu_torch.analysis.visualize",
                    "sls_tpu_torch.cli.analyze", "sls_tpu_torch.cli.report")

# the last slice's modules: the training runners and the parity tools
RUN_MODULES = ("sls_tpu_torch.cli.autotrain", "sls_tpu_torch.cli.sweep",
               "sls_tpu_torch.cli.parity_kit", "sls_tpu_torch.encoder.parity")

BLOCKED = ("jax", "jaxlib", "flax", "optax", "sls_tpu", "pandas", "sklearn", "msgpack")
_BLOCKED_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|sls_tpu|pandas|sklearn|msgpack)\b(?!_torch)", re.M)
_REFERENCE_NAME = re.compile(r"\bsls_tpu\.")


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import sls_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(sls_tpu_torch.__path__, 'sls_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(' '.join(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 30
    assert set(LONG_CLIP_MODULES) <= names
    assert set(PARALLEL_MODULES) <= names
    assert set(OFFLINE_MODULES) <= names
    assert set(FAMILY_MODULES) <= names
    assert set(ENTRY_MODULES) <= names
    assert set(ANALYSIS_MODULES) <= names
    assert set(RUN_MODULES) <= names


def test_analysis_modules_import_without_matplotlib():
    """matplotlib is imported only where a figure is drawn."""
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "import importlib\n"
            f"for name in {ANALYSIS_MODULES!r}:\n"
            "    importlib.import_module(name)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_long_clip_modules_are_checked():
    checked = {str(p.relative_to(ROOT)).removesuffix(".py").replace("/", ".")
               for p in PORT_FILES}
    assert set(LONG_CLIP_MODULES) <= checked
    assert set(PARALLEL_MODULES) <= checked
    assert set(OFFLINE_MODULES) <= checked
    assert set(FAMILY_MODULES) <= checked
    assert set(ENTRY_MODULES) <= checked
    assert set(ANALYSIS_MODULES) <= checked
    assert set(RUN_MODULES) <= checked


def test_transformers_only_in_the_parity_checks_hf_branch():
    """``transformers`` (which the card's machine may lack) is imported in
    one place: inside ``encoder/parity.py``'s HF reference, and every
    module imports without it."""
    where = [(p, m.group(1)) for p in PORT_FILES for m in re.finditer(
        r"^(\s*)(?:import|from)\s+transformers\b", p.read_text(), re.M)]
    assert [str(p.relative_to(ROOT)) for p, _ in where] == ["sls_tpu_torch/encoder/parity.py"]
    assert where[0][1]  # indented: inside a function, not at import time
    text = (ROOT / "sls_tpu_torch" / "encoder" / "parity.py").read_text()
    branch = text[text.index("def _hf_forward"):]
    branch = branch[:branch.index("\ndef ")]
    assert "from transformers import" in branch
    code = ("import sys\n"
            "sys.modules['transformers'] = None\n"
            "import importlib, pkgutil, sls_tpu_torch\n"
            "for m in pkgutil.walk_packages(sls_tpu_torch.__path__, 'sls_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("line", ["import pandas as pd", "from sklearn.metrics import roc_curve",
                                  "import msgpack", "    from flax import serialization",
                                  "import sls_tpu.data.flac"])
def test_blocked_import_pattern_sees_the_missing_packages(line):
    assert _BLOCKED_IMPORT.search(line)
    assert not _BLOCKED_IMPORT.search("from sls_tpu_torch.ckpt import msgpack")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    text = path.read_text()
    assert not _BLOCKED_IMPORT.search(text), path
    assert not _REFERENCE_NAME.search(text), path


def test_entry_points_default_to_the_card():
    from sls_tpu_torch.config import ExperimentConfig, ModelConfig, SAEConfig, tiny_xlsr_config
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.serve.scorer import build_scorer_from_params
    from sls_tpu_torch.train.steps import make_eval_step

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = ModelConfig(encoder=tiny_xlsr_config(),
                      sae=SAEConfig(activation_dim=64, dict_size=256, k=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Detector(cfg)
    model = Detector(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scorer_from_params(ExperimentConfig(model=cfg), model.state_dict())


def test_cli_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from sls_tpu_torch.cli import export, main, serve
    from sls_tpu_torch.serve.export import export_serving

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    monkeypatch.delenv("SLS_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.main(["--tiny", "--model_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--run_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.main([str(tmp_path), "--out", str(tmp_path / "art")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_serving(tmp_path, tmp_path / "art")
