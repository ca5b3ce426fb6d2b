"""comic_tpu_torch/parallel against tests/test_parallel.py's cases: the mesh
sizing rules and their warning and errors, the batch helpers and their
guards, the job bootstrap's environment and backend rule, and batch-split
serving over a mesh of 8 (repeated) CPU devices, whose ids must equal
comic_tpu's 1- and 8-device make_serve_fn exactly."""

import numpy as np
import pytest
import torch

from comic_tpu.configuration import Config as JConfig
from comic_tpu.inference import make_serve_fn as jmake_serve_fn
from comic_tpu.models import captioner as jcap
from comic_tpu.parallel.mesh import make_mesh as jmake_mesh
from comic_tpu.parallel.mesh import replicate as jreplicate
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.inference import make_serve_fn
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.parallel import distributed
from comic_tpu_torch.parallel import mesh as pm
from comic_tpu_torch.tokenization import Vocabulary

torch.set_num_threads(1)

CPU = torch.device("cpu")
EIGHT = [CPU] * 8


def test_make_mesh_for_batch_divisibility():
    assert pm.make_mesh_for_batch(32, devices=EIGHT).size == 8
    assert pm.make_mesh_for_batch(4, devices=EIGHT).size == 4
    assert pm.make_mesh_for_batch(7, devices=EIGHT).size == 7
    assert pm.make_mesh_for_batch(32, 61, devices=EIGHT).size == 1
    assert pm.make_mesh_for_batch(32, limit=2, devices=EIGHT).size == 2
    mesh = pm.make_mesh(3, EIGHT)
    assert mesh.devices == (CPU,) * 3 and mesh.processes == 1


def test_make_mesh_for_batch_warns_on_idle_devices(capsys):
    """The SCST reference operating point (batch 10 on 8 devices) drops to
    5 devices, loudly; exact fits stay silent."""
    assert pm.make_mesh_for_batch(10, devices=EIGHT).size == 5
    out = capsys.readouterr().out
    assert "IDLE" in out and "divisible by 8" in out
    assert "3 devices IDLE" in out and "nearby: [8]" in out
    pm.make_mesh_for_batch(32, devices=EIGHT)
    pm.make_mesh_for_batch(8, limit=4, devices=EIGHT)
    assert "IDLE" not in capsys.readouterr().out


def _fake_job(monkeypatch, world, rank=0):
    monkeypatch.setattr(pm, "in_job", lambda: True)
    monkeypatch.setattr(pm, "process_count", lambda: world)
    monkeypatch.setattr(pm, "process_index", lambda: rank)
    monkeypatch.setattr(pm, "process_device", lambda: CPU)


def test_make_mesh_for_batch_in_a_job(monkeypatch):
    """In a job the mesh spans every process: the global batch must divide
    them and num_data_shards may not leave any out."""
    _fake_job(monkeypatch, 4)
    mesh = pm.make_mesh_for_batch(8, limit=4, devices=EIGHT)
    assert mesh == pm.Mesh((CPU,), 4) and mesh.size == 4
    with pytest.raises(ValueError, match=r"global batch size\(s\) \[6\]"):
        pm.make_mesh_for_batch(8, 6)
    with pytest.raises(ValueError, match="cannot shrink"):
        pm.make_mesh_for_batch(8, limit=2)


def test_available_devices_start_from_the_requested_device(monkeypatch):
    """An indexed card is served alone; the card without an index (the
    default) names every visible card; the CPU is itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert pm.available_devices("cuda:1") == cards[1:]
    assert pm.available_devices("cuda") == cards
    assert pm.available_devices(None) == cards
    assert pm.available_devices("cpu") == [CPU]


def test_shard_batch_layout():
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    blocks = pm.shard_batch(pm.make_mesh(devices=EIGHT), x)
    assert len(blocks) == 8 and all(b.shape == (2, 3) for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
    with pytest.raises(ValueError, match="does not divide"):
        pm.shard_batch(pm.make_mesh(3, EIGHT), x)


class TestLocalBatchGuards:
    """local_batch fails loudly on replicated or misplaced blocks instead
    of silently duplicating rows (multi-process SCST)."""

    def test_disjoint_contiguous_block(self, monkeypatch):
        _fake_job(monkeypatch, 2, rank=1)
        a = np.arange(8 * 3).reshape(8, 3).astype(np.float32)
        blk = pm.global_batch(None, torch.from_numpy(a))
        assert blk.start == 8 and blk.size == 16 and blk.shape == (16, 3)
        np.testing.assert_array_equal(pm.local_batch(blk), a)
        assert pm.local_batch_start(blk) == 8

    def test_beam_major_axis(self, monkeypatch):
        _fake_job(monkeypatch, 2, rank=1)
        a = np.arange(3 * 8).reshape(3, 8).astype(np.float32)
        blk = pm.global_batch(None, a, axis=1)
        assert blk.shape == (3, 16) and pm.local_batch_start(blk, 1) == 8
        np.testing.assert_array_equal(pm.local_batch(blk, axis=1), a)

    def test_replicated_raises(self, monkeypatch):
        _fake_job(monkeypatch, 2)
        with pytest.raises(ValueError, match="replicated"):
            pm.local_batch(np.zeros((16, 3), np.float32))
        with pytest.raises(ValueError, match="replicated"):
            pm.local_batch(pm.ProcessBlock(np.zeros((16, 3)), 0, 16))

    def test_non_contiguous_raises(self, monkeypatch):
        _fake_job(monkeypatch, 2)
        blk = pm.ProcessBlock(np.zeros((8, 3)), 4, 16)
        with pytest.raises(ValueError, match="non-contiguous"):
            pm.local_batch(blk)

    def test_one_process_is_the_identity(self):
        x = torch.arange(6).reshape(3, 2)
        assert pm.global_batch(None, x) is x
        assert pm.feed_global(None, x) is x
        np.testing.assert_array_equal(pm.local_batch(x), x.numpy())
        assert pm.local_batch_start(x) == 0


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_feed_global_takes_the_rank_block(monkeypatch, rank):
    """The same full batch on every process -> rank r's contiguous block,
    placed at r * n of the global batch; global_batch places local rows
    the same way."""
    _fake_job(monkeypatch, 3, rank)
    x = np.arange(12 * 2).reshape(12, 2)
    blk = pm.feed_global(None, x)
    assert (blk.start, blk.size, blk.axis) == (4 * rank, 12, 0)
    np.testing.assert_array_equal(blk.data, x[4 * rank: 4 * rank + 4])
    beams = np.arange(2 * 12).reshape(2, 12)
    blk = pm.feed_global(None, beams, axis=1)
    np.testing.assert_array_equal(pm.local_batch(blk, axis=1),
                                  beams[:, 4 * rank: 4 * rank + 4])
    with pytest.raises(ValueError, match="does not divide"):
        pm.feed_global(None, np.zeros((10, 2)))


def test_collectives_outside_a_job_are_the_identity():
    w = torch.ones(3, requires_grad=True)
    (w * 2).sum().backward()
    calls = pm.all_reduce_grads.calls
    values = torch.tensor([1.0, 2.0])
    assert pm.all_reduce_grads([w], values) is values
    assert pm.all_reduce_grads.calls == calls
    np.testing.assert_array_equal(w.grad.numpy(), [2.0, 2.0, 2.0])
    tree = {"a": torch.zeros(2)}
    assert pm.replicate(pm.make_mesh(devices=[CPU]), tree) is tree
    assert pm.all_reduce_sum(values) is values
    np.testing.assert_array_equal(pm.all_gather_ints([3, 4]), [[3, 4]])
    pm.barrier()
    copy, = pm.start_host_fetch(torch.arange(3))
    np.testing.assert_array_equal(copy.numpy(), [0, 1, 2])


def test_sharding_descriptors():
    mesh = pm.make_mesh(devices=EIGHT)
    assert pm.batch_sharding(mesh) == pm.Sharding(mesh, pm.DATA_AXIS)
    assert pm.replicated(mesh).axis is None


class TestDistributedBootstrap:
    @pytest.fixture
    def calls(self, monkeypatch):
        got = {}
        monkeypatch.setattr(distributed.dist, "is_initialized",
                            lambda: False)
        monkeypatch.setattr(
            distributed.dist, "init_process_group",
            lambda backend, **kw: got.update(backend=backend, **kw))
        for var in ("COMIC_COORDINATOR", "COMIC_NUM_PROCESSES",
                    "COMIC_PROCESS_ID", "LOCAL_RANK"):
            monkeypatch.delenv(var, raising=False)
        return got

    def test_noop_without_coordinator(self, calls):
        assert distributed.maybe_initialize_distributed() is False
        assert distributed.maybe_initialize_distributed(device="cpu") is False
        assert calls == {}

    def test_env_args_and_gloo_on_the_cpu(self, calls, monkeypatch):
        monkeypatch.setenv("COMIC_COORDINATOR", "10.0.0.1:1234")
        monkeypatch.setenv("COMIC_NUM_PROCESSES", "4")
        monkeypatch.setenv("COMIC_PROCESS_ID", "2")
        assert distributed.maybe_initialize_distributed(device="cpu") is True
        assert calls == {"backend": "gloo",
                         "init_method": "tcp://10.0.0.1:1234",
                         "world_size": 4, "rank": 2,
                         "timeout": distributed.TIMEOUT}

    def test_nccl_on_the_rank_card(self, calls, monkeypatch):
        """The card is the default device; rank 3 of a host with 2 cards
        takes card 1 (its local rank), and NCCL binds to it."""
        cards = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "set_device", cards.append)
        assert distributed.maybe_initialize_distributed(
            "host:29500", 4, 3) is True
        card = torch.device("cuda", 1)
        assert cards == [card]
        assert calls == {"backend": "nccl", "init_method": "tcp://host:29500",
                         "world_size": 4, "rank": 3, "device_id": card,
                         "timeout": distributed.TIMEOUT}

    def test_no_card_raises(self, calls, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.maybe_initialize_distributed("host:1", 2, 0)
        assert calls == {}

    def test_auto_reads_torchrun_env(self, calls, monkeypatch):
        monkeypatch.setenv("COMIC_COORDINATOR", "auto")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        assert distributed.maybe_initialize_distributed(device="cpu")
        assert (calls["init_method"], calls["world_size"],
                calls["rank"]) == ("env://", 2, 1)

    def test_missing_process_id_raises(self, calls, monkeypatch):
        monkeypatch.setenv("COMIC_COORDINATOR", "host:1")
        monkeypatch.setenv("COMIC_NUM_PROCESSES", "2")
        with pytest.raises(ValueError, match="COMIC_PROCESS_ID"):
            distributed.maybe_initialize_distributed(device="cpu")
        assert calls == {}


# tests/test_parallel.py::_tiny_setup
WTOI = {"<PAD>": -1, "w": 0, "<UNK>": 1, "<GO>": 2, "<EOS>": 3}
TINY = dict(token_type="radix", radix_base=8, rnn_size=16, rnn_word_size=8,
            attn_num_heads=2, compute_dtype="float32",
            cnn_input_size=(64, 64), dropout_rnn_in=0.0, dropout_rnn_out=0.0,
            attn_keep_prob=1.0, freeze_scopes="", cnn_input_augment=False,
            infer_beam_size=3, infer_max_length=4, scst_beam_size=2)


@pytest.mark.parametrize("beam", [3, 1])
def test_serve_split_over_a_mesh_matches_comic_tpu(beam):
    """Batch-split serving over 8 (CPU) devices and over one gives the ids
    of comic_tpu's 1- and 8-device make_serve_fn, exactly."""
    cfg = dict(TINY, infer_beam_size=beam)
    jc, tc = JConfig(**cfg), Config(**cfg)
    jspec = jcap.build_model_spec(jc, JVocabulary(dict(WTOI)))
    tspec = tcap.build_model_spec(tc, Vocabulary(dict(WTOI)))
    params = tcap.init_params(tspec, torch.Generator().manual_seed(0),
                              device="cpu")
    tree = bridge.to_jax_tree(params)
    steps = jcap.max_decode_steps(jc, JVocabulary(dict(WTOI)))
    images = np.random.default_rng(1).integers(0, 256, (8, 256, 256, 3),
                                               dtype=np.uint8)
    want = []
    for n in (1, 8):
        mesh = jmake_mesh(n)
        serve = jmake_serve_fn(jspec, jc, steps, mesh=mesh,
                               collect_alignments=False)
        want.append(np.asarray(serve(jreplicate(mesh, tree), images)[0]))
    np.testing.assert_array_equal(want[0], want[1])
    for devices in (EIGHT, [CPU]):
        serve = make_serve_fn(tspec, tc, steps, collect_alignments=False,
                              device="cpu", mesh=pm.make_mesh(devices=devices))
        ids, maps = serve(params, images)
        assert maps is None
        np.testing.assert_array_equal(ids.numpy(), want[0])


# --- a job's unit is the host: ranks a host and the job mesh rule ------------

@pytest.mark.parametrize("local, world, rph, hosts", [
    (None, 4, 1, 4),  # gloo on the CPU: every rank a host of its own
    ("2", 4, 2, 2),
    ("4", 4, 4, 1),
    ("8", 8, 8, 1),
])
def test_ranks_per_host_reads_local_world_size(monkeypatch, local, world,
                                               rph, hosts):
    _fake_job(monkeypatch, world)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    if local is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert (pm.ranks_per_host(), pm.host_count()) == (rph, hosts)


def test_ranks_per_host_on_cards_counts_the_hosts_cards(monkeypatch):
    """Under NCCL without LOCAL_WORLD_SIZE a host holds its visible cards,
    or the whole job where it is smaller; outside a job one host."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert (pm.ranks_per_host(), pm.host_count()) == (1, 1)
    _fake_job(monkeypatch, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(pm.dist, "get_backend", lambda: "nccl")
    assert (pm.ranks_per_host(), pm.host_count()) == (4, 2)
    monkeypatch.setattr(pm, "process_count", lambda: 2)
    assert (pm.ranks_per_host(), pm.host_count()) == (2, 1)


def test_a_world_that_does_not_split_into_hosts_raises(monkeypatch):
    _fake_job(monkeypatch, 6)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="does not split into hosts of 4"):
        pm.host_count()
    with pytest.raises(ValueError, match="does not split into hosts"):
        pm.make_mesh_for_batch(8)


def _comic_tpu_mesh(monkeypatch, world, hosts, batches, limit):
    """comic_tpu's make_mesh_for_batch with ``world`` chips over ``hosts``
    processes -> (its device count, or the error it raises; what it
    printed)."""
    import contextlib
    import io

    import jax

    from comic_tpu.parallel import mesh as jmesh

    with monkeypatch.context() as m:
        m.setattr(jax, "devices", lambda: list(range(world)))
        m.setattr(jax, "process_count", lambda: hosts)
        m.setattr(jmesh, "make_mesh",
                  lambda n=None: world if n is None else n)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            try:
                got = jmesh.make_mesh_for_batch(*batches, limit=limit)
            except ValueError as e:
                got = str(e)
    return got, log.getvalue()


def _port_mesh(monkeypatch, world, rph, batches, limit, rank=0):
    import contextlib
    import io

    _fake_job(monkeypatch, world, rank)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(rph))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        try:
            got = pm.make_mesh_for_batch(*batches, limit=limit).processes
        except ValueError as e:
            got = str(e)
    return got, log.getvalue()


@pytest.mark.parametrize("world, rph, batches, limit", [
    (8, 8, (10,), 0),  # SCST's batch 10 on one host of 8: 5 work
    (8, 8, (32,), 0),
    (8, 8, (32,), 4),
    (8, 8, (32, 61), 0),
    (2, 2, (3,), 0),
    (2, 2, (4,), 0),
    (4, 2, (8,), 0),  # two hosts: every rank
    (4, 2, (6,), 0),  # two hosts: refused
    (4, 2, (8,), 2),
    (8, 4, (12,), 0),
])
def test_job_mesh_follows_comic_tpus_rule(monkeypatch, world, rph, batches,
                                          limit):
    """The job's mesh against comic_tpu's on the same counts, a host's
    ranks in the place of its chips: on one host the same shrunk size and
    the same IDLE line (on rank 0; the other ranks print nothing), across
    hosts the same size or the same error."""
    want = _comic_tpu_mesh(monkeypatch, world, world // rph, batches, limit)
    assert _port_mesh(monkeypatch, world, rph, batches, limit) == want
    got, log = _port_mesh(monkeypatch, world, rph, batches, limit, rank=1)
    assert got == want[0] and log == ""
