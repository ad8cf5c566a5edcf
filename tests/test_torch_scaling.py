"""qtpu_torch.bench.scaling and scaling_projection against qtpu's, on the
CPU (mirrors tests/test_scaling.py).

* ``dp_scaling`` of LeNet-5 (``lenet_mnist_int8``, served on the module
  path) at dp = 1 and 2, each a world of gloo CPU ranks: qtpu's keys,
  positive images/s, and ``efficiency_vs_linear`` equal to qtpu's
  ``dp_scaling`` given the same images/s; on ``cuda`` a dp above the card
  count is refused.
* ``collective_link`` on recorded collectives against qtpu's
  ``collective_ici`` on a hand-written HLO text with the same collectives:
  the traffic in bytes equal for every kind, the times equal once each
  side's link rate is the other's (qtpu's ring runs at twice its one-way
  rate, its point to point at one).
* ``project`` equal to qtpu's for the same t1 and traffic (alpha = 1).
* The records of a TP = 2 forward of a narrow ResNet (bottleneck, width
  16, CIFAR stem) in one world of two gloo CPU ranks (``python
  tests/test_torch_scaling.py tp <dir>``, no JAX): as many as the calls
  ``collectives.counts`` counted, every one over the group of 2, each
  all-gather's bytes half its gathered layer output, B·H·W·C_out/2.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP_ARCH = dict(stage_sizes=(1, 1, 1, 1), width=16, bottleneck=True,
               cifar_stem=True, num_classes=10)
LENET = dict(config="lenet_mnist_int8")
FACTORY = "qtpu_torch.bench.scaling:factory_forward"

# the same five collectives: as qtpu's optimized HLO prints them, and as
# the port records them (the operand this rank hands in)
HLO = """
%all-gather.1 = s8[8,14,14,64]{3,2,1,0} all-gather(s8[8,14,14,32]{3,2,1,0} %p0), channel_id=1, replica_groups={{0,1}}, dimensions={3}, use_global_device_ids=true
%all-reduce.2 = f32[1024]{0} all-reduce(f32[1024]{0} %p1), channel_id=2, replica_groups={{0,1}}, to_apply=%add
%reduce-scatter.3 = f32[512]{0} reduce-scatter(f32[1024]{0} %p2), channel_id=3, replica_groups={{0,1}}, dimensions={0}, to_apply=%add
%all-to-all.4 = f32[2,256]{1,0} all-to-all(f32[2,256]{1,0} %p3), channel_id=4, replica_groups={{0,1}}, dimensions={0}
%collective-permute.5 = s8[8,2,56,64]{3,2,1,0} collective-permute(s8[8,2,56,64]{3,2,1,0} %p4), channel_id=5, source_target_pairs={{0,1},{1,0}}
"""
RECORDS = [dict(kind="all_gather", group=2, bytes=8 * 14 * 14 * 32),
           dict(kind="all_reduce", group=2, bytes=4 * 1024),
           dict(kind="reduce_scatter", group=2, bytes=4 * 1024),
           dict(kind="all_to_all", group=2, bytes=4 * 2 * 256),
           dict(kind="ppermute", group=2, bytes=8 * 2 * 56 * 64)]


def test_dp_scaling_lenet_gloo(monkeypatch, tmp_path):
    from qtpu.bench import scaling as j_scaling
    from qtpu.bench import timing as j_timing
    from qtpu_torch.bench.scaling import dp_scaling

    out = dp_scaling(FACTORY, (28, 28, 1), dps=(1, 2), batch_per_device=4,
                     factory_kwargs=LENET, device="cpu", n_short=2,
                     n_long=5, timeout_s=240, workdir=str(tmp_path))
    assert set(out) == {"images_per_sec", "efficiency_vs_linear"}
    ips = out["images_per_sec"]
    assert set(ips) == {1, 2} and all(v > 0 for v in ips.values())
    assert out["efficiency_vs_linear"][1] == 1.0
    # qtpu's formula over the same images/s: its time_scan_fit answers the
    # per-iteration seconds that give them
    monkeypatch.setattr(j_timing, "time_scan_fit",
                        lambda body, x, **kw: x.shape[0] / ips[
                            x.shape[0] // 4])
    want = j_scaling.dp_scaling(lambda x: x, (28, 28, 1), dps=(1, 2),
                                batch_per_device=4)
    for dp in (1, 2):
        assert want["images_per_sec"][dp] == pytest.approx(ips[dp],
                                                           rel=1e-12)
        assert out["efficiency_vs_linear"][dp] == pytest.approx(
            want["efficiency_vs_linear"][dp], rel=1e-12)


def test_dp_scaling_refuses_ranks_sharing_a_card():
    from qtpu_torch.bench.scaling import dp_scaling

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="needs a card per rank"):
        dp_scaling(FACTORY, (28, 28, 1), dps=(cards + 1,),
                   factory_kwargs=LENET, device="cuda")


def test_collective_link_matches_qtpu_traffic():
    from qtpu.bench.scaling_projection import (V5E_ICI_LINK_BPS,
                                               collective_ici)
    from qtpu_torch.bench.scaling_projection import (NVLINK_BPS,
                                                     collective_link)

    want = collective_ici(HLO, 2)
    got = collective_link(RECORDS, 2)
    assert [r["kind"].replace("-", "_") for r in want["rows"]] == [
        "all_gather", "all_reduce", "reduce_scatter", "all_to_all",
        "collective_permute"]
    assert [r["ici_bytes"] for r in got["rows"]] == [
        r["ici_bytes"] for r in want["rows"]]
    assert got["ici_bytes_per_device"] == want["ici_bytes_per_device"]
    assert got["n_collectives"] == want["n_collectives"] == 5
    for r in got["rows"]:
        assert r["t_us"] == round(r["ici_bytes"] / NVLINK_BPS * 1e6, 2)
    # the same times at qtpu's rates: its rings at twice the one-way link
    rings = collective_link(RECORDS[:4], 2, link_bps=2 * V5E_ICI_LINK_BPS)
    p2p = collective_link(RECORDS[4:], 2, link_bps=V5E_ICI_LINK_BPS)
    assert [r["t_us"] for r in rings["rows"] + p2p["rows"]] == [
        r["t_us"] for r in want["rows"]]


@pytest.mark.parametrize("tp", [1, 2])
def test_project_matches_qtpu(tp):
    from qtpu.bench.scaling_projection import V5E_ICI_LINK_BPS
    from qtpu.bench.scaling_projection import project as j_project
    from qtpu_torch.bench.scaling_projection import project

    ring_hlo = "\n".join(HLO.strip().splitlines()[:4])
    want = j_project(8.5e-3, ring_hlo, 2, tp=tp)
    got = project(8.5e-3, RECORDS[:4], 2, tp=tp,
                  link_bps=2 * V5E_ICI_LINK_BPS)
    assert want["alpha_exposed"] == 1.0
    assert got == want


def test_projection_main_reads_the_records(tmp_path, capsys, monkeypatch):
    """``main`` takes the config and batch from the records' JSON, and
    without ``--t1-ms`` measures t1 on the card or raises: no fallback."""
    from qtpu_torch.bench import scaling_projection as sp
    from qtpu_torch.bench import timing

    path = tmp_path / "tp2.json"
    path.write_text(json.dumps(dict(tp=2, batch=32, config="lenet_mnist_int8",
                                    records=RECORDS[:4])))
    assert sp.main(["--records", str(path), "--t1-ms", "8.5"]) == 0
    head, row = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert head == dict(t1_ms=8.5, batch=32, t1_source="--t1-ms")
    assert row["config"] == "lenet_mnist_int8" and row["batch_per_chip"] == 32
    assert row == dict(sp.project(8.5e-3, RECORDS[:4], 2, tp=2), dp=1,
                       batch_per_chip=32, batch_total=32,
                       config="lenet_mnist_int8", model="MODEL")
    asked = []
    monkeypatch.setattr(sp, "measure_t1_ms",
                        lambda batch, config: asked.append((batch, config))
                        or 2.0)
    monkeypatch.setattr(timing, "device_label", lambda device: "CARD, 700 W")
    assert sp.main(["--records", str(path)]) == 0
    assert asked == [(32, "lenet_mnist_int8")]
    head = json.loads(capsys.readouterr().out.splitlines()[0])
    assert head["t1_ms"] == 2.0 and head["t1_source"].endswith("CARD, 700 W")
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no fallback"):
        sp.main(["--records", str(path)])


# -- a TP = 2 forward's records, two gloo ranks ------------------------

def _rank_tp(d):
    """One rank: the sharded engine's forward under
    ``collectives.recording``, each all-gather's gathered shape beside."""
    import torch.distributed as dist

    from qtpu_torch.parallel import (collectives, distributed, make_mesh,
                                     shard_variables)
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
    from qtpu_torch.utils import checkpoint as ckpt

    distributed.initialize_from_env()
    tree = ckpt.load(os.path.join(d, "tree"), device="cpu")
    mesh = make_mesh(dp=1, tp=dist.get_world_size())
    eng = ResNetInt8Engine(shard_variables(tree, mesh), TP_ARCH,
                           device="cpu")
    x = torch.load(os.path.join(d, "x.pt"))
    gathered, gather = [], collectives.all_gather

    def spy(t, group, dim=0):
        y = gather(t, group, dim)
        gathered.append((tuple(y.shape), y.element_size()))
        return y

    collectives.all_gather = spy
    collectives.reset_counts()
    try:
        with collectives.recording() as records:
            eng.forward(x)
    finally:
        collectives.all_gather = gather
    torch.save(dict(records=records, counts=dict(collectives.counts),
                    gathered=gathered),
               os.path.join(d, f"tp_rank{dist.get_rank()}.pt"))
    distributed.shutdown()
    return 0


def test_tp_forward_records(tmp_path):
    from qtpu_torch.bench.scaling_projection import project
    from qtpu_torch.models import get_model, init_weights
    from qtpu_torch.nn import QuantPolicy
    from qtpu_torch.parallel.launch import run_world
    from qtpu_torch.transform import calibrate, freeze
    from qtpu_torch.utils import checkpoint as ckpt

    model = get_model("resnet50", num_classes=10, cifar_stem=True, width=16,
                      stage_sizes=TP_ARCH["stage_sizes"])
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    policy = QuantPolicy.int8_ptq()
    ckpt.save(str(tmp_path / "tree"),
              freeze(model, policy, calibrate(model, policy, [x])))
    torch.save(x, tmp_path / "x.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    res = run_world([sys.executable, os.path.abspath(__file__), "tp",
                     str(tmp_path)], 2, str(tmp_path / "rdzv"),
                    timeout_s=120, backend="gloo", env=env)
    for r in res:
        assert r.returncode == 0, f"rank {r.rank}:\n{r.output[-6000:]}"
    for rank in range(2):
        out = torch.load(tmp_path / f"tp_rank{rank}.pt", weights_only=False)
        records, counts = out["records"], out["counts"]
        assert len(records) == sum(v for k, v in counts.items()
                                   if "." not in k)
        assert all(r["group"] == 2 for r in records)
        gathers = [r for r in records if r["kind"] == "all_gather"]
        assert len(gathers) == counts["all_gather"] == len(out["gathered"])
        assert gathers
        for r, (shape, esize) in zip(gathers, out["gathered"]):
            assert r["bytes"] * 2 == int(np.prod(shape)) * esize, (r, shape)
        row = project(1e-3, records, 2, tp=2)
        assert row["n_collectives"] == len(records)
        assert row["ici_bytes_per_device"] > 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    sys.exit(globals()[f"_rank_{sys.argv[1]}"](sys.argv[2]))
