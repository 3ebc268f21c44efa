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

# the multi-process slice's modules
PARALLEL_MODULES = ("sls_tpu_torch.parallel.distributed", "sls_tpu_torch.parallel.mesh",
                    "sls_tpu_torch.parallel.sequence", "sls_tpu_torch.parallel.launch",
                    "sls_tpu_torch.parallel.workers")

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


def test_long_clip_modules_are_checked():
    checked = {str(p.relative_to(ROOT)).removesuffix(".py").replace("/", ".")
               for p in PORT_FILES}
    assert set(LONG_CLIP_MODULES) <= checked
    assert set(PARALLEL_MODULES) <= checked
    assert set(OFFLINE_MODULES) <= checked
    assert set(FAMILY_MODULES) <= checked


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
