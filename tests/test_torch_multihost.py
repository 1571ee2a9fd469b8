"""Multi-process training of the port over torch.distributed (gloo), on
the CPU (``parallel/multihost.py``, the trainer's ranks, ``cli/train.py``):

* ``initialize`` alone is a no-op; torchrun's and the JAX CLI's launch
  variables are parsed, conflicting or incomplete ones raise; ``host_shard``
  equals JAX's; ``local_cells`` covers layouts (a) and (b); any other
  layout raises before a rendezvous;
* ``PackedLoader.plan_windows`` equals JAX's and the serial loader's
  windows on a spec tight enough to shrink and carry, native and Python;
* two gloo ranks run the JAX multi-process test's seven trainer phases
  (``tests/test_multiprocess.py``) and one with dropout: both ranks agree
  exactly, equal the port's single-process run (bit for bit where each
  rank holds one group, else rtol 1e-6) and the JAX single-process trainer
  (rtol 1e-4, from one JAX init checkpoint); only rank 0 writes;
* layout (b), one EP shard a rank, on a set with a chain cut across the
  shards: 2 ranks' step against ``run_lockstep`` (SSE, gradients, the
  parameters after a step; also ``ep_overlap``, and ``ep_rdma_exchange``
  through the cross-rank K12's entry point), 4 ranks (n_dp 2, n_ep 2)
  and 2 ranks against the single-process trainer, 2 ranks against the JAX
  trainer with n_ep 2;
* the cross-rank exchange alone (``tools/k12_ranks.py``) over 4 ranks,
  caps (8, 0, 16), f32 and bf16, both ways and its backward, against
  JAX's ``ring_exchange_rdma`` (interpret mode under ``shard_map``) bit
  for bit;
* a two-rank ``cli.train.main`` through torchrun's variables; the config
  fingerprint guard; a rank whose peer is gone raises.

The file is also the ranks' program: ``python tests/test_torch_multihost.py
'<json>'`` runs one child (see :func:`_child`), which imports nothing of
JAX.  Every child is waited on with a timeout; the rendezvous of the
trainer-level children is a ``file://`` one in the test's directory.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve()
CHILD_TIMEOUT = 240

# the JAX multi-process test's reactions (tests/test_multiprocess.py)
SMILES = ["CCO>>CC=O", "CC(=O)N>>CC(=O)N", "C=CC=C>>C=CC=C",
          "[N:1]([H:2])([H:3])[H:4]>>[N:1]([H:2])[H:3].[H:4]",
          "CCO>C>CCO", "O>C>CO", "N>C>CN", "CC>>CC"]
LABELS = [float(i + 1) for i in range(len(SMILES))]
TRAIN = (SMILES + SMILES[:4], LABELS + [float(i + 10) for i in range(4)])
VAL = (SMILES[4:], [float(i + 2) for i in range(4)])
PHASES = ("dp", "dpreuse", "dpep", "dpde", "dpepde", "dpresume", "dpcarry",
          "dpdrop")
# phases in which each of the 2 ranks holds one dp group: a sum over ranks
# has two operands, so they equal one process bit for bit
ONE_GROUP_A_RANK = ("dpep", "dpepde", "dpdrop")
NF, FE = 78, 14
# the 4-rank exchange job (tools/k12_ranks.py; the CPU takes gloo's move)
K12_JOB = dict(caps=[[8, 0, 16]], dtypes=["float32", "bfloat16"], H=24,
               calls=6, device="cpu", outputs=True)


def _phase_kw(phase: str, out: Path) -> dict:
    """The trainer's hyperparameters of a phase (those of the JAX test's
    ``_trainer_phase_kwargs``; ``dpdrop``: dropout 0.2, port only), and
    the pack spec's tile as ``spec``."""
    kw = dict(name=f"mh-{phase}", lr=1e-3, num_epochs=2, val_frequency=1,
              seed=0, model_save_dir=str(out / phase),
              spec=(8, 8, 2) if phase == "dpcarry" else (64, 48, 2))
    kw.update({
        "dp": dict(n_dp=4, batch_size=8),
        "dpreuse": dict(n_dp=4, batch_size=8, reuse_packs=True,
                        num_epochs=3),
        "dpep": dict(n_dp=2, n_ep=2, batch_size=4, ep_te=64, ep_tn=48),
        "dpde": dict(n_dp=4, batch_size=8, reuse_packs=True,
                     device_epoch=True),
        "dpepde": dict(n_dp=2, n_ep=2, batch_size=4, ep_te=64, ep_tn=48,
                       reuse_packs=True, device_epoch=True),
        "dpresume": dict(n_dp=4, batch_size=8, num_epochs=3,
                         resume_from=str(out / "dp" / "mh-dp.latest.npz")),
        "dpcarry": dict(n_dp=4, batch_size=8),
        "dpdrop": dict(n_dp=2, batch_size=8, num_epochs=3),
    }[phase])
    return kw


def _write_csvs(data: Path) -> None:
    data.mkdir(parents=True, exist_ok=True)
    for name, (smis, labs) in (("train", TRAIN), ("val", VAL),
                               ("test", VAL)):
        with open(data / f"{name}.csv", "w") as f:
            f.write("smiles,ea\n")
            f.writelines(f"{s},{y}\n" for s, y in zip(smis, labs))


class WiredSet:
    """A ChemDataset stand-in (both packages' trainers take it): 11 small
    synthetic graphs and a 400-atom chain, which edge partitioning cuts
    across the shards."""

    def __init__(self, seed: int = 5):
        from cgr_mpnn_3d_tpu_torch.data.synthetic import (chain_graph,
                                                          synthetic_graphs)
        rng = np.random.default_rng(seed)
        self.graphs = synthetic_graphs(11, rng, node_feat_dim=NF) + \
            [chain_graph(400, rng, NF)]
        self.labels = np.linspace(1.0, 3.0, len(self.graphs)).astype(
            np.float32)
        self.use_npz = False
        self.num_node_features, self.num_edge_features = NF, FE

    def __len__(self):
        return len(self.graphs)

    def graph(self, i):
        return self.graphs[i]


def _wired_kw(run: str, out: Path) -> dict:
    """The trainer's hyperparameters of a wired-set run: ``ep2`` (n_ep 2,
    dropout 0: against JAX too) and ``ep4`` (n_dp 2, n_ep 2, dropout
    0.1)."""
    kw = dict(name=f"mh-{run}", lr=1e-3, num_epochs=2, val_frequency=1,
              seed=0, model_save_dir=str(out / run), ep_te=64, ep_tn=32,
              batch_size=6, n_ep=2)
    if run == "ep4":
        kw.update(n_dp=2, batch_size=3)
    return kw


# ---------------------------------------------------------------------------
# the children (no JAX here or in anything they import)
# ---------------------------------------------------------------------------

def _digest(tr) -> str:
    """sha256 of the trainer's parameters and Adam state, in order."""
    import torch
    h = hashlib.sha256()
    for p in tr.model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
        for k in sorted(tr.optimizer.state.get(p, {})):
            v = tr.optimizer.state[p][k]
            h.update(v.cpu().numpy().tobytes() if torch.is_tensor(v)
                     else repr(v).encode())
    return h.hexdigest()


def _result(tr, out: dict) -> dict:
    import torch
    flat = torch.cat([p.detach().reshape(-1).double()
                      for p in tr.model.parameters()])
    return {"train": out["train_losses"], "val": out["val_losses"],
            "steps": out["steps"], "digest": _digest(tr),
            "params": flat.tolist()}


def _port_cfg(drop: float, **kw):
    from cgr_mpnn_3d_tpu_torch.models import CGRMPNNConfig
    return CGRMPNNConfig(num_node_features=NF, num_edge_features=FE,
                         depth=2, hidden_sizes=(16, 16),
                         dropout_ps=(drop, drop), **kw)


def _run_phase(phase: str, data: Path, out: Path, init: str) -> dict:
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, plan_spec
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    kw = _phase_kw(phase, out)
    train = ChemDataset(str(data / "train.csv"))
    te, tn, tb = kw.pop("spec")
    spec = plan_spec([train.graph(i) for i in range(len(train))], te=te,
                     tn=tn, tb=tb)
    kw.setdefault("resume_from", init)
    tr = RxnGraphTrainer(cfg=_port_cfg(0.2 if phase == "dpdrop" else 0.0),
                         train_data=train,
                         val_data=ChemDataset(str(data / "val.csv")),
                         spec=spec, device="cpu", **kw)
    return _result(tr, tr.train())


def _run_wired(run: str, out: Path, init: str) -> dict:
    from cgr_mpnn_3d_tpu_torch.data import PackSpec
    from cgr_mpnn_3d_tpu_torch.train import RxnGraphTrainer
    data = WiredSet()
    tr = RxnGraphTrainer(cfg=_port_cfg(0.1 if run == "ep4" else 0.0),
                         train_data=data, val_data=data, spec=PackSpec(),
                         device="cpu", resume_from=init,
                         **_wired_kw(run, out))
    return _result(tr, tr.train())


def _ep_step(rank: int, world: int, overlap: bool,
             rdma: bool = False) -> dict:
    """One training step on the wired set's batch, n_ep 2: over 2 ranks
    (layout (b)) this rank's shard; in one process both shards through
    ``run_lockstep``.  The SSE, the summed gradients, the parameters after
    one Adam step, and the calls of the cross-rank K12's entry point."""
    import torch
    from cgr_mpnn_3d_tpu_torch.models import init_params
    from cgr_mpnn_3d_tpu_torch.parallel import (ep_pack, ep_shards,
                                                multihost, pack_shard_edges)
    from cgr_mpnn_3d_tpu_torch.parallel.ep_pack import \
        make_ep_pack_train_step
    data = WiredSet()
    batch, spec = pack_shard_edges(data.graphs, list(data.labels), 2,
                                   te=64, tn=32)
    assert any(spec.caps), "the chain must be cut"
    shards = ep_shards(batch, "cpu")
    seeds = torch.tensor([[[11, 12], [13, 14]]], dtype=torch.int32)
    cfg = _port_cfg(0.1, aggr="add", pooling="mean", ep_overlap=overlap,
                    ep_rdma_exchange=rdma)
    if world == 1:
        groups, sd, comm = [shards], seeds, None
    else:
        groups, sd = [[shards[rank]]], seeds[:, rank:rank + 1]
        comm = multihost.ep_comm(multihost.layout(1, 2))
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    adam = torch.optim.Adam(model.parameters(), lr=1e-3, amsgrad=True)
    entry, calls = ep_pack.rank_exchange_rdma, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return entry(*a, **kw)
    ep_pack.rank_exchange_rdma = counted
    try:
        sse = make_ep_pack_train_step(model, spec, comm)(groups, sd)
    finally:
        ep_pack.rank_exchange_rdma = entry
    grads = torch.cat([p.grad.reshape(-1).double()
                       for p in model.parameters()])
    adam.step()
    return {"sse": float(sse), "grads": grads.tolist(),
            "params": torch.cat([p.detach().reshape(-1).double()
                                 for p in model.parameters()]).tolist(),
            "rank_k12_calls": calls[0]}


def _child(job: dict) -> None:
    """One rank (or the single process, world 1) of a test: runs the
    ``job["modes"]`` in turn and prints ``RESULT <json>``."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    from cgr_mpnn_3d_tpu_torch.train import trainer
    writes = []
    save = trainer.save_checkpoint

    def counted(path, *a, **kw):
        writes.append(Path(path).name)
        return save(path, *a, **kw)
    trainer.save_checkpoint = counted
    rank, world = job.get("rank", 0), job.get("world", 1)
    if world > 1:
        multihost.initialize(f"file://{job['rdv']}", world, rank,
                             timeout_s=60)
        assert multihost.world_size() == world and multihost.rank() == rank
    out = Path(job.get("out", "."))
    res: dict = {"rank": rank, "primary": multihost.is_primary()}
    for mode in job["modes"]:
        _run_mode(mode, job, rank, world, out, res)
    res["writes"] = writes
    if world > 1 and "mismatch" not in job["modes"] \
            and "peer_gone" not in job["modes"]:
        multihost.sync_global_devices()
    print("RESULT " + json.dumps(res, default=float), flush=True)


def _run_mode(mode: str, job: dict, rank: int, world: int, out: Path,
              res: dict) -> None:
    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    if mode == "phases":
        for phase in job["phases"]:
            res[phase] = _run_phase(phase, Path(job["data"]), out,
                                    job["init"])
    elif mode == "wired":
        for run in job["runs"]:
            res[run] = _run_wired(run, out, job["init"])
    elif mode == "ep_step":
        res["add"] = _ep_step(rank, world, False)
        res["overlap"] = _ep_step(rank, world, True)
        res["rdma"] = _ep_step(rank, world, False, rdma=True)
    elif mode == "exchange":
        from cgr_mpnn_3d_tpu_torch.tools.k12_ranks import run
        res["exchange"] = run(K12_JOB)
    elif mode == "mismatch":
        try:
            _run_phase("dpdrop", Path(job["data"]), out / f"r{rank}",
                       job["init"]) if rank == 0 else \
                _mismatched(Path(job["data"]), out, job["init"])
        except ValueError as e:
            res["error"] = str(e)
    elif mode == "peer_gone":
        if rank == 1:
            print("RESULT " + json.dumps(res), flush=True)
            os._exit(0)
        try:
            multihost.sync_global_devices()
        except RuntimeError as e:
            res["peer_error"] = type(e).__name__
    elif mode == "cli":
        from cgr_mpnn_3d_tpu_torch.cli.train import main
        os.chdir(out)
        res["cli"] = main(job["argv"])


def _mismatched(data: Path, out: Path, init: str) -> None:
    """Rank 1 of the mismatch test: ``dpdrop`` with another seed."""
    import cgr_mpnn_3d_tpu_torch.train.trainer as trainer
    cls = trainer.RxnGraphTrainer
    orig = cls.__post_init__

    def other_seed(self):
        self.seed = 1
        orig(self)
    cls.__post_init__ = other_seed
    _run_phase("dpdrop", data, out / "r1", init)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "MASTER_", "WORLD_SIZE",
                                "RANK", "LOCAL_RANK"))}
    env["PYTHONPATH"] = str(REPO)
    return env


def _spawn(jobs: list[dict], env: dict | None = None) -> list:
    return [subprocess.Popen([sys.executable, str(HERE), json.dumps(j)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=str(REPO),
                             env={**_env(), **(env or {}), **j.get("env", {})})
            for j in jobs]


def _wait(procs: list, timeout: float = CHILD_TIMEOUT) -> list[dict]:
    """Each child's RESULT; a child that fails or outlives ``timeout``
    fails the test, and every child is gone when this returns."""
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"a child outlived {timeout} s")
            assert p.returncode == 0, f"child failed:\n{out}\n{err}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, f"no RESULT:\n{out}\n{err}"
            outs.append(dict(json.loads(line[-1][7:]), stdout=out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_trainer(kw: dict, data=None, wired=False):
    """The JAX package's trainer on the same data and hyperparameters."""
    import cgr_mpnn_3d_tpu.data as jdata
    import cgr_mpnn_3d_tpu.models as jm
    from cgr_mpnn_3d_tpu.train import RxnGraphTrainer as JaxTrainer
    kw = dict(kw)
    if wired:
        train = val = WiredSet()
        spec = jdata.PackSpec()
    else:
        train = jdata.ChemDataset(str(data / "train.csv"))
        val = jdata.ChemDataset(str(data / "val.csv"))
        te, tn, tb = kw.pop("spec")
        spec = jdata.plan_spec([train.graph(i) for i in range(len(train))],
                               te=te, tn=tn, tb=tb)
    cfg = jm.CGRMPNNConfig(num_node_features=NF, num_edge_features=FE,
                           depth=2, hidden_sizes=(16, 16),
                           dropout_ps=(0.0, 0.0))
    return JaxTrainer(cfg=cfg, train_data=train, val_data=val, spec=spec,
                      **kw)


def _jax_k12() -> dict:
    """JAX's ``ring_exchange_rdma`` (the Pallas kernel in interpret mode
    under ``shard_map`` on a 1 x 4 mesh) on K12_JOB's buffers, every
    shard's rows [4, TW, H] as float32: {(dtype, "fwd" | "inv" | "bwd")};
    "bwd" is the inverse exchange of the cotangents, the backward's
    expected gradients."""
    import jax
    import jax.numpy as jnp
    from cgr_mpnn_3d_tpu.parallel import P, make_mesh
    from cgr_mpnn_3d_tpu.parallel.rdma_exchange import ring_exchange_rdma
    from cgr_mpnn_3d_tpu_torch.tools.k12_ranks import buffers
    caps = tuple(K12_JOB["caps"][0])
    n = len(caps) + 1
    mesh = make_mesh(n_dp=1, n_ep=n, devices=jax.devices()[:n])
    out = {}
    for name in K12_JOB["dtypes"]:
        for way, seed, inverse in (("fwd", 0, False), ("inv", 0, True),
                                   ("bwd", 1, True)):
            fn = jax.jit(jax.shard_map(
                lambda b, inverse=inverse: ring_exchange_rdma(
                    b[0], caps, "ep", inverse=inverse, interpret=True)[None],
                mesh=mesh, in_specs=(P(("dp", "ep")),),
                out_specs=P(("dp", "ep")), check_vma=False))
            bufs = jnp.asarray(buffers(seed, n, sum(caps), K12_JOB["H"]),
                               getattr(jnp, name))
            out[name, way] = np.asarray(fn(bufs)).astype(np.float32)
    return out


def _jax_result(kw: dict, data=None, wired=False) -> dict:
    import jax
    tr = _jax_trainer(kw, data, wired)
    out = tr.train()
    return {"train": out["train_losses"], "val": out["val_losses"],
            "checksum": float(sum(np.abs(np.asarray(leaf)).sum(dtype=np.float64)
                                  for leaf in jax.tree_util.tree_leaves(
                                      tr.state.params)))}


CLI_ARGV = ["-d", "2", "--hidden_sizes", "16", "--dropout_ps", "0.1",
            "-ne", "2", "-bs", "8", "--val_frequency", "1", "--save_path",
            "saved", "--device", "cpu", "--dp", "2", "--num_workers", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every child of the file, started together, and the JAX references
    computed here meanwhile, from one JAX init checkpoint.  The children:
    2 ranks that run the phases, then the wired set with n_ep 2, then the
    layout (b) step; 4 ranks of the wired set; the single process that
    runs all of it; 2 ranks of ``cli.train.main`` through torchrun's
    variables; 2 ranks with different seeds, of which rank 1 then leaves
    (the fingerprint guard, then a peer that is gone); 4 ranks of the
    cross-rank exchange alone."""
    tmp = tmp_path_factory.mktemp("mh")
    data = tmp / "data"
    _write_csvs(data)
    jt = _jax_trainer(dict(_phase_kw("dp", tmp / "jinit"), n_dp=1), data)
    jt._epoch_done = -1
    init = str(jt.save(tmp / "init.npz"))
    base = dict(data=str(data), init=init)
    steps = ["phases", "wired", "ep_step"]
    jobs = [dict(base, modes=steps, phases=PHASES, runs=["ep2"], rank=r,
                 world=2, rdv=str(tmp / "rdv_two"), out=str(tmp / "ranks"))
            for r in range(2)]
    jobs += [dict(base, modes=["wired"], runs=["ep4"], rank=r, world=4,
                  rdv=str(tmp / "rdv_ep4"), out=str(tmp / "ranks"))
             for r in range(4)]
    jobs += [dict(base, modes=steps, phases=PHASES, runs=["ep2", "ep4"],
                  out=str(tmp / "one"))]
    port = _free_port()
    for r in range(2):
        (tmp / f"cli{r}").mkdir()
        jobs.append(dict(modes=["cli"], out=str(tmp / f"cli{r}"),
                         argv=CLI_ARGV + ["--data_path", str(data)],
                         env={"MASTER_ADDR": "localhost",
                              "MASTER_PORT": str(port), "WORLD_SIZE": "2",
                              "RANK": str(r), "LOCAL_RANK": str(r)}))
    jobs += [dict(modes=["mismatch", "peer_gone"], rank=r, world=2,
                  rdv=str(tmp / "rdv_guard"), data=str(data),
                  out=str(tmp / "guard"), init="") for r in range(2)]
    jobs += [dict(modes=["exchange"], rank=r, world=4,
                  rdv=str(tmp / "rdv_k12"), out=str(tmp / "k12"))
             for r in range(4)]
    procs = _spawn(jobs)
    try:
        ref = {ph: _jax_result(dict(_phase_kw(ph, tmp / "jax"),
                                    **({} if ph == "dpresume"
                                       else {"resume_from": init})), data)
               for ph in PHASES if ph != "dpdrop"}
        ref["ep2"] = _jax_result(dict(_wired_kw("ep2", tmp / "jax"),
                                      resume_from=init), wired=True)
        ref["k12"] = _jax_k12()
    finally:
        res = _wait(procs)
    return dict(phases=res[0:2], ep2=res[0:2], step=res[0:2], ep4=res[2:6],
                one=res[6], one_wired=res[6], cli=res[7:9], guard=res[9:11],
                k12=res[11:15], jax=ref, tmp=tmp)


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


def _near(got, want, rtol, what):
    """max |got - want| <= rtol * max |want|: parameters, some of them near
    zero, held as a whole."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("phase", PHASES)
def test_two_ranks_equal_one_process(runs, phase):
    """Both ranks agree exactly; they equal the port's single-process run
    (bit for bit where each rank holds one group, otherwise the losses at
    rtol 1e-6 and the parameters within 1e-6 of their largest) and
    the JAX single-process trainer (rtol 1e-4; not ``dpdrop``: the two
    packages' dropout masks differ); only rank 0 wrote its checkpoints."""
    r0, r1 = (r[phase] for r in runs["phases"])
    one = runs["one"][phase]
    assert r0 == r1
    assert [r["primary"] for r in runs["phases"]] == [True, False]
    assert any(w.startswith(f"mh-{phase}") for w in
               runs["phases"][0]["writes"])
    assert runs["phases"][1]["writes"] == []
    assert (runs["tmp"] / "ranks" / phase / f"mh-{phase}.npz").exists()
    assert r0["steps"] == one["steps"] > 0
    if phase in ONE_GROUP_A_RANK:
        assert (r0["train"], r0["val"], r0["digest"]) == \
            (one["train"], one["val"], one["digest"])
    else:
        _close(r0["train"], one["train"], 1e-6, phase)
        _close(r0["val"], one["val"], 1e-6, phase)
        _near(r0["params"], one["params"], 1e-6, phase)
    if phase != "dpdrop":
        ref = runs["jax"][phase]
        _close(r0["train"], ref["train"], 1e-4, phase)
        _close(r0["val"], ref["val"], 1e-4, phase)
        _close(sum(abs(v) for v in r0["params"]), ref["checksum"], 1e-4,
               phase)


def test_the_tight_spec_carries_and_the_plan_is_the_serial_loaders(runs):
    """``dpcarry``'s spec shrinks windows and carries rows (else its
    equality is vacuous), and ``plan_windows`` gives the serial loader's
    windows and JAX's plan, native and Python, shuffled at two epochs."""
    import cgr_mpnn_3d_tpu.data as jdata
    from cgr_mpnn_3d_tpu.data.loader import PackedLoader as JLoader
    from cgr_mpnn_3d_tpu_torch.data import ChemDataset, PackedLoader, \
        plan_spec
    data = runs["tmp"] / "data"
    ds = ChemDataset(str(data / "train.csv"))
    jds = jdata.ChemDataset(str(data / "train.csv"))
    spec = plan_spec([ds.graph(i) for i in range(len(ds))], te=8, tn=8,
                     tb=2)
    jspec = jdata.PackSpec(**vars(spec))
    for native in (True, False):
        ld = PackedLoader(ds, spec, batch_size=2, shuffle=True, seed=0,
                          use_native=native)
        jl = JLoader(jds, jspec, batch_size=2, shuffle=True, seed=0,
                     use_native=native)
        for epoch in (0, 1):
            ld.set_epoch(epoch)
            jl.set_epoch(epoch)
            plan = ld.plan_windows(ld._order())
            assert any(len(w) < 2 for w in plan), "the spec did not carry"
            assert plan == jl.plan_windows(jl._order())
            rows = [sorted(int(i) for i in b.row_ids[b.graph_mask > 0])
                    for b in ld]
            assert [sorted(w) for w in plan] == rows


def test_layout_b_step_equals_run_lockstep(runs):
    """2 ranks, one EP shard each, on the wired set (a 400-atom chain cut
    across them; add aggregation, mean pooling, dropout 0.1, also
    ``ep_overlap`` and ``ep_rdma_exchange``): each rank's SSE equals
    ``run_lockstep``'s (``rdma=True`` for the last) bit for bit, the
    all-reduced gradients and the parameters after one Adam step are
    within 1e-5 of their largest (the ranks sum the shards' gradients in
    another order), and the two ranks agree exactly.  With
    ``ep_rdma_exchange`` every exchange request of the ranks goes to the
    cross-rank K12's entry point (gloo's move is its plain version here),
    and without it none does."""
    r0, r1 = runs["step"]
    for case in ("add", "overlap", "rdma"):
        ref, a, b = runs["one_wired"][case], r0[case], r1[case]
        assert a == b, case
        assert a["sse"] == ref["sse"], case
        for key in ("grads", "params"):
            _near(a[key], ref[key], 1e-5, f"{case} {key}")
        assert (a["rank_k12_calls"] > 0) == (case == "rdma"), case
    assert r0["rdma"]["sse"] == r0["add"]["sse"]


def test_four_rank_exchange_equals_jax(runs):
    """The cross-rank exchange over 4 ranks of one EP group (caps (8, 0,
    16), f32 and bf16, tools/k12_ranks.py): each rank's output both ways
    equals its row of JAX's ``ring_exchange_rdma`` bit for bit, its
    autograd backward equals the inverse exchange of the cotangents (JAX's
    too), and each equals the one-process ``_ring_move`` and gloo's move,
    also after a chain of exchanges."""
    ref = runs["jax"]["k12"]
    caps = tuple(K12_JOB["caps"][0])
    for r, got in enumerate(runs["k12"]):
        assert got["exchange"]["shard"] == r
        for name in K12_JOB["dtypes"]:
            case = got["exchange"]["cases"][f"{caps} {name}"]
            assert all(v for k, v in case.items() if k.endswith("_equal")), \
                (r, name, case)
            for way in ("fwd", "inv", "bwd"):
                np.testing.assert_array_equal(
                    np.asarray(case[way], np.float32), ref[name, way][r],
                    err_msg=f"rank {r} {name} {way}")


@pytest.mark.parametrize("run", ["ep2", "ep4"])
def test_layout_b_trainer_equals_one_process(runs, run):
    """The trainer with one EP shard a rank on the wired set: 2 ranks
    (n_ep 2, dropout 0) and 4 ranks (n_dp 2, n_ep 2, dropout 0.1, each
    rank its slice of the global seed draw): every rank agrees exactly, and
    the run equals the single-process one (losses rtol 1e-6, parameters
    within 1e-5 of their largest: the gradients are summed over the shards
    in another order);
    2 ranks are within rtol 1e-4 of the JAX trainer with n_ep 2."""
    ranks = runs[run]
    one = runs["one_wired"][run]
    assert all(r[run] == ranks[0][run] for r in ranks)
    assert all(r["writes"] == [] for r in ranks[1:]) and ranks[0]["writes"]
    got = ranks[0][run]
    assert got["steps"] == one["steps"] > 0
    _close(got["train"], one["train"], 1e-6, run)
    _close(got["val"], one["val"], 1e-6, run)
    _near(got["params"], one["params"], 1e-5, run)
    if run == "ep2":
        ref = runs["jax"]["ep2"]
        _close(got["train"], ref["train"], 1e-4, run)
        _close(got["val"], ref["val"], 1e-4, run)
        _close(sum(abs(v) for v in got["params"]), ref["checksum"], 1e-4,
               run)


def test_two_rank_cli_writes_once(runs):
    """``cli.train.main`` on 2 ranks through torchrun's variables
    (``--dp 2``, 2 epochs, with the test split): both exit 0 with the same
    losses; only rank 0 wrote the checkpoints, the metrics log and the
    results, and printed the summary."""
    r0, r1 = runs["cli"]
    assert r0["cli"]["train_losses"] == r1["cli"]["train_losses"]
    assert np.isfinite(r0["cli"]["test_losses"])
    assert "test_losses" not in r1["cli"]
    w0, w1 = runs["tmp"] / "cli0", runs["tmp"] / "cli1"
    assert list((w0 / "saved").glob("*.npz"))
    assert len(list((w0 / "runs").glob("*.jsonl"))) == 1
    assert (w0 / "hyperparameter_study" /
            "CGR_hyperparameter_study.json").exists()
    assert r1["writes"] == [] and not (w1 / "saved").exists() or \
        not list((w1 / "saved").glob("*"))
    assert not (w1 / "runs").exists() and \
        not (w1 / "hyperparameter_study").exists()
    assert '"test_losses"' in r0["stdout"] and \
        '"test_losses"' not in r1["stdout"]


def test_config_mismatch_raises_on_every_rank(runs):
    """Ranks with different seeds both raise ValueError at the trainer's
    construction, naming the gathered fingerprints."""
    for r in runs["guard"]:
        assert "multi-process config mismatch" in r["error"]
        assert "fingerprints" in r["error"]


def test_a_rank_whose_peer_is_gone_raises(runs):
    """Rank 1 leaves after the mismatch: rank 0's next barrier raises
    (gloo sees the closed connection) instead of waiting."""
    assert runs["guard"][0]["peer_error"] == "RuntimeError"


def test_initialize_alone_is_a_no_op(monkeypatch):
    from cgr_mpnn_3d_tpu_torch.parallel import multihost
    for key in multihost.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    multihost.initialize()
    assert (multihost.world_size(), multihost.rank(),
            multihost.is_primary()) == (1, 0, True)
    multihost.sync_global_devices()
    t = np.ones(3, np.float32)
    multihost.all_reduce_sum_([])
    np.testing.assert_array_equal(multihost.all_gather_rows(t), t[None])
    assert multihost.local_cells(2, 2) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert multihost.launch_env() is None
    assert multihost.check_launch(1, 1).kind == "one"


def test_launch_environments():
    from cgr_mpnn_3d_tpu_torch.parallel import multihost as mh
    torchrun = {"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0",
                "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"}
    jax_env = {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:29500",
               "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2"}
    assert mh.launch_env(torchrun) == ("tcp://10.0.0.1:29500", 4, 2, 0)
    assert mh.launch_env(jax_env) == ("tcp://10.0.0.1:29500", 4, 2, 2)
    assert mh.launch_env({**torchrun, **jax_env})[:3] == \
        ("tcp://10.0.0.1:29500", 4, 2)
    assert mh.launch_env({"WORLD_SIZE": "1"}) is None
    for bad, text in (({**torchrun, **jax_env, "JAX_PROCESS_ID": "3"},
                       "describe different launches"),
                      ({**torchrun, **jax_env, "JAX_NUM_PROCESSES": "2"},
                       "disagree on the number of processes"),
                      ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "0"},
                       "without ['JAX_COORDINATOR_ADDRESS']"),
                      ({**torchrun, "MASTER_PORT": ""}, "['MASTER_PORT']"),
                      ({**torchrun, "RANK": "4"}, "outside a world of 4"),
                      ({"JAX_COORDINATOR_ADDRESS": "h:1"},
                       "without a process count")):
        with pytest.raises(ValueError, match=None) as err:
            mh.launch_env(bad)
        assert text in str(err.value)


def test_layouts_and_host_shard():
    """``local_cells`` of layout (a) (whole groups a rank) and (b) (one
    shard a rank), ranks row-major as the JAX mesh lays out processes;
    other layouts raise; ``host_shard`` equals JAX's."""
    from cgr_mpnn_3d_tpu.parallel import multihost as jmh
    from cgr_mpnn_3d_tpu_torch.parallel import multihost as mh
    cells = lambda n_dp, n_ep, w: [mh.layout(n_dp, n_ep, w, r).cells
                                   for r in range(w)]
    assert cells(4, 1, 2) == [[(0, 0), (1, 0)], [(2, 0), (3, 0)]]
    assert cells(2, 2, 2) == [[(0, 0), (0, 1)], [(1, 0), (1, 1)]]
    assert cells(4, 2, 4) == [[(g, 0), (g, 1)] for g in range(4)]
    assert cells(1, 2, 2) == [[(0, 0)], [(0, 1)]]
    assert cells(2, 2, 4) == [[(0, 0)], [(0, 1)], [(1, 0)], [(1, 1)]]
    assert mh.layout(2, 2, 4, 1).kind == "shards"
    assert mh.layout(4, 2, 2, 1).kind == "groups"
    for n_dp, n_ep, w, exc in ((1, 1, 2, ValueError), (3, 1, 2, ValueError),
                               (2, 3, 4, ValueError),
                               (1, 2, 4, ValueError)):
        with pytest.raises(exc):
            mh.layout(n_dp, n_ep, w, 0)
    assert mh.layout(1, 2, 2, 0, ep_rdma=True).kind == "shards"
    assert mh.layout(2, 2, 4, 3, ep_rdma=True).cells == [(1, 1)]
    assert mh.layout(2, 2, 2, 0, ep_rdma=True).kind == "groups"
    for n, pid, nproc in ((10, 0, 3), (10, 2, 3), (7, 1, 2), (0, 0, 1)):
        np.testing.assert_array_equal(mh.host_shard(n, pid, nproc),
                                      jmh.host_shard(n, pid, nproc))


if __name__ == "__main__":
    _child(json.loads(sys.argv[1]))
