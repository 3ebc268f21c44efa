"""ASVspoof protocol files (own copy of ``sls_tpu/data/protocols.py``):

- 5-column train/dev protocols: ``speaker utt - system {bonafide|spoof}``;
- one-utterance-per-line eval lists (2021 LA / DF), and In-the-Wild
  lists, whose ids already carry ``.wav``.

Labels: **1 = bonafide, 0 = spoof**.  Any other label token raises: a
capitalised label, ``genuine`` or a header row mapped silently to spoof
would corrupt the labels without an error.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple, Union

PathLike = Union[str, Path]

BONAFIDE_LABEL = 1
SPOOF_LABEL = 0


@dataclasses.dataclass(frozen=True)
class ProtocolEntry:
    """One row of a 5-column CM protocol file."""

    speaker: str
    utt_id: str
    system_id: str  # attack id, '-' for bonafide
    label: int  # 1 = bonafide, 0 = spoof


def _label_from_token(token: str, path, line: str) -> int:
    if token == "bonafide":
        return BONAFIDE_LABEL
    if token == "spoof":
        return SPOOF_LABEL
    raise ValueError(f"{path}: unknown label token {token!r} (expected 'bonafide' or "
                     f"'spoof') in line: {line!r}")


def _rows(path: PathLike):
    """The fields of each non-blank line of a 5-column protocol, with
    the line."""
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) != 5:
                raise ValueError(f"{path}: expected 5 columns, got {len(fields)}: {line!r}")
            yield fields, line


def parse_train_protocol(path: PathLike) -> Tuple[Dict[str, int], List[str]]:
    """(labels by utterance, utterance ids in file order) of a 5-column
    protocol."""
    labels: Dict[str, int] = {}
    utt_ids: List[str] = []
    for (_, utt_id, _, _, label), line in _rows(path):
        utt_ids.append(utt_id)
        labels[utt_id] = _label_from_token(label, path, line)
    return labels, utt_ids


def parse_train_protocol_full(path: PathLike) -> List[ProtocolEntry]:
    """The rows of a 5-column protocol with speaker and attack id (for
    per-attack breakdowns)."""
    return [ProtocolEntry(speaker=spk, utt_id=utt_id, system_id=system_id,
                          label=_label_from_token(label, path, line))
            for (spk, utt_id, _, system_id, label), line in _rows(path)]


def parse_eval_list(path: PathLike) -> List[str]:
    """The utterance ids of a one-id-per-line eval list, blank lines
    skipped."""
    utt_ids: List[str] = []
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if line:
                utt_ids.append(line)
    return utt_ids
