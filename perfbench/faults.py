"""Faults planted in the program under test, each a context manager that
patches one of its functions for the duration: what a check has to
catch.  The tests hold each cell's run to them on the CPU, and
``calibrate.py --fault`` reads them on the card.

- ``answers_altered``: every answer with its classes' columns swapped
  where it is produced;
- ``half_batch``: the forward (scoring and training) computes the first
  half of the rows and gives the rest their mean;
- ``state_unchanged``: a train step that leaves the parameters and the
  optimizer state as they were.

The cells run on one chip, so no exchange between chips can be left out.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from unittest import mock

import torch

FORWARDS = ("sls_tpu_torch.models.detector.Detector", "sls_tpu_torch.models.sls.SLSDetector")


def _klass(path: str):
    module, name = path.rsplit(".", 1)
    return getattr(__import__(module, fromlist=[name]), name)


def _swap(out):
    if isinstance(out, dict):
        return dict(out, log_probs=out["log_probs"][:, [1, 0]],
                    score=torch.exp(out["log_probs"][:, 0]))
    return out[:, [1, 0]]


def _halved(orig):
    def forward(self, wav, *args, **kwargs):
        half = wav.shape[0] // 2
        out = orig(self, wav[:half], *args, **kwargs)

        def fill(t):
            if not torch.is_tensor(t) or not t.dim() or t.shape[0] != half:
                return t
            rest = t.mean(0, keepdim=True).expand(wav.shape[0] - half, *t.shape[1:])
            return torch.cat([t, rest.to(t.dtype)])

        return {k: fill(v) for k, v in out.items()} if isinstance(out, dict) else fill(out)

    return forward


@contextmanager
def answers_altered():
    with ExitStack() as stack:
        for path in FORWARDS:
            klass = _klass(path)
            for method in ("forward", "score"):
                orig = getattr(klass, method)
                stack.enter_context(mock.patch.object(
                    klass, method, lambda self, *a, _orig=orig, **k: _swap(_orig(self, *a, **k))))
        yield


@contextmanager
def half_batch():
    with ExitStack() as stack:
        for path in FORWARDS:
            klass = _klass(path)
            for method in ("forward", "score"):
                stack.enter_context(mock.patch.object(klass, method,
                                                      _halved(getattr(klass, method))))
        yield


@contextmanager
def state_unchanged():
    from sls_tpu_torch.train.steps import AdamL2

    with mock.patch.object(AdamL2, "update", lambda self, state, g, finite: None):
        yield


FAULTS = {"answers_altered": answers_altered, "half_batch": half_batch,
          "state_unchanged": state_unchanged}
