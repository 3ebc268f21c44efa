"""The port's multi-process helpers: ``host_shard`` and
``pad_batch_to_devices`` against the JAX package's, the host-array
collectives and part-file merge on gloo ranks, and a two-rank score file
against the single-process one."""

import jax
import numpy as np
import pytest
import torch

from sls_tpu.data.pipeline import DatasetIndex
from sls_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sls_tpu.parallel.mesh import pad_batch_to_devices as jax_pad_batch
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.data.pipeline import ArrayLoader, to_wire
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel import distributed as tdist
from sls_tpu_torch.parallel import workers
from sls_tpu_torch.parallel.launch import launch
from sls_tpu_torch.parallel.mesh import Mesh, SeqShard, make_mesh, pad_batch_to_devices
from sls_tpu_torch.train.loop import produce_scores
from sls_tpu_torch.train.steps import make_eval_step


@pytest.mark.parametrize("n, count", [(10, 3), (7, 2), (8, 4), (3, 4)])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_host_shard_matches_jax(n, count, drop_remainder):
    ids = [f"u{i}" for i in range(n)]
    labels = np.arange(n) % 2
    index = DatasetIndex(utt_ids=ids, paths=[f"/x/{u}.flac" for u in ids], labels=labels)
    loader = ArrayLoader(np.arange(n, dtype=np.float32)[:, None], labels, ids, batch_size=2)
    seen = []
    for i in range(count):
        ref = index.host_shard(i, count, drop_remainder)
        got = loader.host_shard(i, count, drop_remainder)
        assert got.utt_ids == ref.utt_ids
        np.testing.assert_array_equal(got.labels, ref.labels)
        np.testing.assert_array_equal(got.wavs[:, 0], [int(u[1:]) for u in ref.utt_ids])
        assert got.batch_size == 2
        seen += got.utt_ids
    if drop_remainder:
        assert len(seen) == count * (n // count)
    else:
        assert sorted(seen) == sorted(ids)  # the scoring shards cover every example once


@pytest.mark.parametrize("n", [1, 5, 8, 14])
@pytest.mark.parametrize("with_labels", [False, True])
def test_pad_batch_to_devices_matches_jax(n, with_labels):
    rng = np.random.default_rng(n)
    wav = rng.normal(size=(n, 6)).astype(np.float32)
    labels = rng.integers(0, 2, n) if with_labels else None
    valid = rng.random(n) > 0.2
    ref = jax_pad_batch(jax_make_mesh(jax.devices()[:4]), wav, labels, valid)
    mesh = Mesh(("data",), {"data": 4}, (0, 1, 2, 3), {"data": 0}, {"data": None})
    got = pad_batch_to_devices(mesh, wav, labels, valid)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, r)
    assert len(got[0]) % 4 == 0


def test_single_process_is_the_identity(tmp_path, monkeypatch):
    for name in ("SLS_TPU_COORDINATOR", "SLS_TPU_NUM_PROCESSES", "SLS_TPU_PROCESS_ID",
                 "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.initialize() is False  # nothing configured: a plain single process
    assert (tdist.process_index(), tdist.process_count(), tdist.is_primary()) == (0, 1, True)
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(tdist.allgather_rows(x), x)
    np.testing.assert_array_equal(tdist.allgather_ragged_rows(x), x)
    np.testing.assert_array_equal(tdist.allreduce_sum_scalars([1, 2.5]), [1.0, 2.5])
    out = tmp_path / "scores.txt"
    assert tdist.part_path(out) == str(out)
    tdist.merge_part_files(out)  # no-op: nothing to merge, nothing raised
    tdist.sync_hosts()
    t = torch.arange(4.0)
    assert torch.equal(tdist.all_gather_cat(t), t)
    assert tdist.local_device("cpu") == torch.device("cpu")


def test_initialize_refuses_half_given_settings(monkeypatch):
    monkeypatch.delenv("SLS_TPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("SLS_TPU_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="without num_processes"):
        tdist.initialize("localhost:1")
    assert tdist.choose_backend("cpu", 4) == "gloo"
    if not torch.cuda.is_available():
        assert tdist.choose_backend("cuda", 1) == "gloo"  # no card for the rank


def test_one_rank_mesh_and_its_shard():
    mesh = make_mesh(("data", "seq"), shape=(1, 1))
    assert mesh.coords == {"data": 0, "seq": 0} and mesh.ranks == (0,)
    assert mesh.groups == {"data": None, "seq": None}
    shard = SeqShard(mesh, "seq", rows=3, frames=7)
    x = torch.arange(3 * 7 * 2.0).reshape(3, 7, 2)
    assert torch.equal(shard.take_frames(shard.take_rows(x)), x)
    assert torch.equal(shard.gather_rows(shard.gather_frames(x)), x)
    assert torch.equal(shard.sum_frames(x.sum(1)), x.sum(1))
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(("data", "seq"), shape=(2, 2))
    with pytest.raises(ValueError, match="not an axis"):
        SeqShard(mesh, "model", 1, 1)


def test_seq_shard_cuts_cover_every_row_and_frame():
    """Every (data, seq) coordinate's cut of a [B, T] grid, ragged T
    included: together they tile it once."""
    for rows, frames, n_data, n_seq in [(4, 49, 2, 4), (3, 49, 2, 2), (2, 512, 1, 4),
                                        (2, 3, 1, 4)]:
        x = torch.arange(rows * frames).reshape(rows, frames, 1)
        seen = torch.zeros(rows, frames, dtype=torch.int64)
        for d in range(n_data):
            for s in range(n_seq):
                mesh = Mesh(("data", "seq"), {"data": n_data, "seq": n_seq},
                            tuple(range(n_data * n_seq)), {"data": d, "seq": s},
                            {"data": None, "seq": None})
                shard = SeqShard(mesh, "seq", rows, frames)
                part = shard.take_frames(shard.take_rows(x))
                assert part.shape[1] <= shard.chunk
                seen.view(-1)[part.reshape(-1)] += 1
        # rows the data axis does not divide stay whole on every data coordinate
        assert torch.all(seen == (1 if rows % n_data == 0 else n_data))


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parts")
    return launch(workers.collectives_rank, 3, (str(tmp),), device_type="cpu", timeout_s=120)


def test_host_collectives_on_three_ranks(collectives):
    for rank, res in enumerate(collectives):
        assert (res["rank"], res["count"], res["primary"]) == (rank, 3, rank == 0)
        np.testing.assert_array_equal(res["rows"], np.repeat([0.0, 1.0, 2.0], 2)[:, None]
                                      * np.ones((1, 3), np.float32))
        np.testing.assert_array_equal(res["ragged"][:, 0], [0, 1, 1, 2, 2, 2])
        np.testing.assert_array_equal(res["sum"], [3.0, 3.0])


def test_part_files_merge_in_rank_order(collectives):
    for rank, res in enumerate(collectives):
        assert res["part"] == f"merged.txt.part{rank}"
        assert res["merged"] == "".join(f"line of rank {r}\n" for r in range(3))
        assert res["parts_left"] == []


def test_missing_part_raises_on_every_rank(collectives):
    for res in collectives:
        assert res["missing_part_error"] is not None
        assert "missing 1 part file(s)" in res["missing_part_error"]
    assert "lost.txt.part2" in collectives[0]["missing_part_error"]  # the primary names it


def test_two_rank_score_file_equals_single_process(tmp_path):
    cfg = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), classifier_hidden=32,
                           sae=tcfg.SAEConfig(activation_dim=64, dict_size=256, k=32))
    model = Detector(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    n, batch = 11, 4
    wire = to_wire(np.random.default_rng(0).normal(0, 0.1, (n, 1000)).astype(np.float32),
                   "int16")
    ids = [f"utt_{i}" for i in range(n)]
    single = tmp_path / "single.txt"
    written = produce_scores(make_eval_step(model, device="cpu"),
                             ArrayLoader(wire, None, ids, batch), single)
    assert written == n
    merged = tmp_path / "merged.txt"
    ranks = launch(workers.produce_scores_rank, 2,
                   (cfg, {"state": state}, "cpu", wire, ids, batch, str(merged)),
                   device_type="cpu", timeout_s=120)
    assert [r["count"] for r in ranks] == [n, n]  # the global count on every rank
    assert [r["local"] for r in ranks] == [6, 5]
    lines = merged.read_text().splitlines()
    # the parts follow in rank order, each rank's strided shard in its own order
    assert [ln.split()[0] for ln in lines] == ids[0::2] + ids[1::2]
    # line for line the single-process file's: the same utterance gets the
    # same text, whatever batch and rank scored it
    assert sorted(lines) == sorted(single.read_text().splitlines())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["merged.txt", "single.txt"]
