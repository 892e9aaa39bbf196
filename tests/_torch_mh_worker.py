"""One process of the port's elastic multi-process runs (``--elastic on``
across processes, ``runtime/rendezvous.py``).

Launched by ``tests/test_torch_mh.py`` and ``chip_smoke.py`` [7d] as
``python tests/_torch_mh_worker.py <proc_id> <num_procs> <port>``. It
imports torch, numpy and the port, never JAX. The JAX package's harness
(``tests/_mh_worker.py``) is its model, mode for mode:

* default: the world comes up through ``rendezvous.elastic_initialize``
  (process 0 hosts the store on ``localhost:<port>``), the ranks train an
  elastic DBS run with a checkpoint and an epoch-start marker file
  (``epoch<e>_p<ident>.marker`` under ``DBS_PEER_HB_DIR``) every epoch,
  and a survivor of a peer's SIGKILL re-rendezvouses over the survivors.
  ``DBS_MH_WEDGE=<id>`` wedges that process's rendezvous (its beacon
  alive, ``agree`` stalled); ``DBS_MH_RESPAWNED=1`` with ``DBS_MH_IDENT``
  marks a respawned joiner, which offers a join and enters the grown
  world; ``DBS_MH_JOIN_AT=<e>`` holds process 0 before epoch ``e`` until
  a join offer is on disk (bounded), so a joiner always finds a boundary;
  ``DBS_MH_STEP_MARKER=<ident>:<e>:<k>`` makes that process write
  ``epoch<e>_step<k>_p<ident>.marker`` just before its ``k``-th combine of
  epoch ``e`` (0-based), so a launcher can kill it inside the epoch's
  gradient collectives; with ``DBS_MH_HOLD=1`` it also holds there (beacon
  alive) until the launcher kills or stops it, while its peers wait inside
  that step's collective, however short the epochs are on the CPU.
* ``DBS_MH_PARITY=1``: the parity leg, a fresh one-process run at the
  reduced fleet, restored from ``DBS_MH_CKPT``, its controller vectors set
  from ``DBS_MH_PARITY_VECS`` (the survivor-restricted sidecar), over the
  remaining epochs (up to ``DBS_MH_PARITY_UNTIL``, exclusive, when set).

The run: MnistNet on the synthetic MNIST stand-in (512 training and 128
test examples), ``-ws 4`` (``DBS_MH_WS``), ``-b 128``, one device a
process, ``--packed off`` (the elastic path, as the JAX harness's two
devices a process take), a deterministic 3:1 timing model per original
worker that follows the live fleet, ``--stream_chunk_steps 2``, seed 7.
``DBS_MH_INIT`` names a ``torch.save`` of initial parameters by name (the
JAX trainer's, bridged), loaded with every dropout off. For the card:
``DBS_MH_DEVICE=cuda``, ``DBS_MH_MODEL``/``DBS_MH_DATASET``/
``DBS_MH_BATCH``/``DBS_MH_NTRAIN`` (the run's shape) and
``DBS_MH_STRAGGLER`` (a virtual straggler profile and the card's probes
instead of the timing model), cuDNN deterministic.

Each process prints one ``RESULT <json>`` line: its ident, world size,
process count, roster, the train losses, the parameters' SHA-256 and the
shares after every epoch it ran (``hashes``, ``shares_after``), the
elastic events, the partitions, the final shares and the kernels' launch
counts. Any failure exits 17 without the interpreter's teardown (a peer
that is the reason for the failure must not be waited on).
"""

import dataclasses
import hashlib
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

JOIN_WAIT_S = 120.0  # how long process 0 holds at DBS_MH_JOIN_AT for a join offer


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def params_hash(model) -> str:
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()


def factored_timing(holder, base_factors):
    """Seconds per original worker following the live fleet (the JAX
    harness's ``_factored_timing``)."""

    def tm(plan):
        tr = holder["tr"]
        f = np.asarray(base_factors, dtype=np.float64)[np.asarray(tr.active_ranks)]
        return f * np.array([w.batch_size * w.steps * 1e-3 for w in plan.workers])

    return tm


def make_config(ws: int, num_procs: int, epochs: int, ck: str, elastic: str = "on"):
    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config

    logs = os.path.join(os.path.dirname(os.path.abspath(ck)), "logs")
    # the survivors of a reduced fleet are the original ranks 0..ws-1
    straggler = ",".join(_env("DBS_MH_STRAGGLER", "").split(",")[:ws]).strip(",")
    return Config(
        debug=True,
        world_size=ws,
        batch_size=int(_env("DBS_MH_BATCH", "128")),
        learning_rate=0.05,
        epoch_size=epochs,
        dataset=_env("DBS_MH_DATASET", "mnist"),
        model=_env("DBS_MH_MODEL", "mnistnet"),
        dynamic_batch_size=True,
        bucket=8,
        stream_chunk_steps=2,
        packed="off",
        elastic=elastic,
        ckpt_dir=ck,
        seed=7,
        device=0,
        num_processes=num_procs if num_procs > 1 else 0,
        straggler=straggler,
        fault_mode="virtual",
        n_train=int(_env("DBS_MH_NTRAIN", "512")),
        log_dir=logs,
        stat_dir=logs,
    )


def build_trainer(cfg):
    """The port's trainer on the harness's data, timing and weights."""
    from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

    device = _env("DBS_MH_DEVICE", "cpu")
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    bundle = synthetic_dataset(cfg.dataset, n_train=cfg.n_train, n_test=128)
    holder = {}
    timing = None if cfg.straggler else factored_timing(holder, ([3.0, 1.0, 1.0, 1.0] * 2)[
        :cfg.world_size])
    tr = Trainer(cfg, bundle=bundle, timing_model=timing, device=device, log_to_file=False)
    holder["tr"] = tr
    init = os.environ.get("DBS_MH_INIT")
    if init:
        weights = torch.load(init, weights_only=True)
        with torch.no_grad():
            for name, p in tr.model.named_parameters():
                p.copy_(weights[name])
        for m in tr.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return tr


def result(tr, rec, hashes, extra=None) -> dict:
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    out = {
        "ident": tr._orig_proc_id,
        "world_size": tr.world_size,
        "n_proc": tr.n_proc,
        "roster": list(tr._proc_roster),
        "losses": [float(v) for v in rec.data["train_loss"]],
        "partitions": [list(map(float, p)) for p in rec.data["partition"]],
        "params_hash": params_hash(tr.model),
        "hashes": hashes,
        "elastic_events": rec.meta.get("elastic_events", []),
        "shares": [float(s) for s in tr.shares],
        "node_times": [float(t) for t in tr.node_times],
        "launches": dict(runtime.LAUNCHES),
    }
    out.update(extra or {})
    return out


def mark_step(hb_dir: str, spec: str, hold: bool):
    """Wrap ``Trainer._combine_step`` so that process ``ident`` writes its
    step marker before its ``k``-th combine of epoch ``e`` (``spec`` is
    ``<ident>:<e>:<k>``), and holds there when ``hold``. Returns the
    holder whose ``"epoch"`` the epoch loop sets."""
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

    ident, epoch, step = (int(v) for v in spec.split(":"))
    state = {"epoch": -1, "steps": 0}
    combine = Trainer._combine_step

    def _combine_step(self, key):
        if self._orig_proc_id == ident and state["epoch"] == epoch:
            if state["steps"] == step:
                name = f"epoch{epoch}_step{step}_p{ident}.marker"
                with open(os.path.join(hb_dir, name), "w") as f:
                    f.write("started")
                while hold:  # held until the launcher kills or stops it
                    time.sleep(0.5)
            state["steps"] += 1
        return combine(self, key)

    Trainer._combine_step = _combine_step
    return state


def main_elastic(proc_id: int, num_procs: int, port: int) -> None:
    from dynamic_load_balance_distributeddnn_tpu_torch.runtime import rendezvous as rdzv
    from dynamic_load_balance_distributeddnn_tpu_torch.runtime.health import ProcessHeartbeat
    from dynamic_load_balance_distributeddnn_tpu_torch.train.checkpoint import flush_checkpoints

    hb_dir = os.environ["DBS_PEER_HB_DIR"]
    ck = os.environ["DBS_MH_CKPT"]
    epochs = int(_env("DBS_MH_EPOCHS", "3"))
    ws = int(_env("DBS_MH_WS", "4"))
    ident = proc_id
    if _env("DBS_MH_WEDGE", "") == str(proc_id):
        # the timeout-degrade seam: this peer stays ALIVE (its beacon beats)
        # but never reaches the rendezvous; the wedge lives in the harness
        def _stall(self, *a, **k):
            while True:
                time.sleep(0.5)

        rdzv.RendezvousStateMachine.agree = _stall
    joined_at = None
    if _env("DBS_MH_RESPAWNED", "") == "1":
        # a respawned process joins the RUNNING fleet at the survivors'
        # next epoch boundary, then builds its trainer over the grown world
        ident = int(os.environ["DBS_MH_IDENT"])
        hb = ProcessHeartbeat(period_s=float(_env("DBS_PEER_HB_PERIOD_S", "0.2")))
        hb.beacon(hb_dir, f"proc{ident}")
        t0 = time.perf_counter()
        sm, ag, payload = rdzv.join_elastic_world(hb_dir, ident)
        joined_at = time.perf_counter() - t0
        hb.stop()  # the trainer arms its own beacon on the same file
        print(f"JOINED gen={ag.gen} rank={ag.rank} roster={list(ag.roster)} "
              f"payload={json.dumps(payload)}", flush=True)
    else:
        rdzv.elastic_initialize(f"localhost:{port}", num_procs, proc_id, rdzv_dir=hb_dir)
    import torch.distributed as dist

    cfg = make_config(ws, dist.get_world_size(), epochs, ck)
    if os.environ.get("DBS_MH_TRACE_SPOOL"):
        # flight-recorder chaos mode: ring trace + crash-durable spool,
        # fast flush so the SIGKILL window is tight
        spool = os.environ["DBS_MH_TRACE_SPOOL"]
        cfg = dataclasses.replace(cfg, trace="ring", trace_spool=spool, trace_spool_flush_s=0.05,
                                  trace_dir=os.path.join(spool, "traces"))
    tr = build_trainer(cfg)
    start = tr._maybe_restore()
    hashes, shares_after = {}, {}
    join_at = int(_env("DBS_MH_JOIN_AT", "-1"))
    marked = (mark_step(hb_dir, os.environ["DBS_MH_STEP_MARKER"], _env("DBS_MH_HOLD", "") == "1")
              if os.environ.get("DBS_MH_STEP_MARKER") else {})
    for e in range(start, epochs):
        if e == join_at and tr._rdzv is not None and tr._orig_proc_id == 0:
            deadline = time.monotonic() + JOIN_WAIT_S
            while not tr._rdzv.pending_joins() and time.monotonic() < deadline:
                time.sleep(0.1)
            time.sleep(0.5)  # the joiner's beacon is fresh: it beat before offering
        with open(os.path.join(hb_dir, f"epoch{e}_p{tr._orig_proc_id}.marker"), "w") as f:
            f.write("started")
        marked["epoch"] = e
        tr._run_epoch_elastic_world(e)
        tr._save_checkpoint(e)
        hashes[str(e)] = params_hash(tr.model)
        shares_after[str(e)] = [float(x) for x in tr.shares]
    flush_checkpoints(cfg.ckpt_dir)
    tr.close_spool()
    print("RESULT " + json.dumps(result(tr, tr.recorder, hashes, {
        "proc": proc_id, "shares_after": shares_after, "joined_s": joined_at,
        "retired_runtimes": rdzv.retired_count(),
        "gen": tr._rdzv.gen if tr._rdzv is not None else None})), flush=True)
    if tr._rdzv is not None:
        tr._rdzv.finalize(timeout_s=30)
    sys.stdout.flush()
    os._exit(0)


def main_parity() -> None:
    """The parity leg: a FRESH one-process run at the reduced fleet from the
    same checkpoint and the survivor-restricted vectors."""
    ck = os.environ["DBS_MH_CKPT"]
    epochs = int(_env("DBS_MH_EPOCHS", "3"))
    vecs = json.loads(os.environ["DBS_MH_PARITY_VECS"])
    ws = len(vecs["shares"])
    tr = build_trainer(make_config(ws, 1, epochs, ck, elastic="off"))
    start = tr._maybe_restore()
    tr.shares = np.asarray(vecs["shares"], dtype=np.float64)
    tr.node_times = np.asarray(vecs["node_times"], dtype=np.float64)
    hashes = {}
    for e in range(start, int(_env("DBS_MH_PARITY_UNTIL", str(epochs)))):
        tr.run_epoch(e)
        hashes[str(e)] = params_hash(tr.model)
    print("RESULT " + json.dumps(result(tr, tr.recorder, hashes, {"proc": -1,
                                                                   "start_epoch": start})),
          flush=True)


def main() -> None:
    proc_id, num_procs, port = (int(a) for a in sys.argv[1:4])
    if _env("DBS_MH_PARITY", "") == "1":
        return main_parity()
    return main_elastic(proc_id, num_procs, port)


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        # a deterministic nonzero exit WITHOUT the interpreter's teardown:
        # the peers that are the reason for the failure must not be waited on
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(17)
