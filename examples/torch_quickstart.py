"""Quickstart on the PyTorch port: boot a V-BOINC capsule and train a
small LM with volunteers (the counterpart of ``examples/quickstart.py``).

The paper's full Figure-1 flow: the server publishes a capsule -> the
client fetches and verifies it and probes its dependencies -> the
volunteer scheduler hands out work units that a quorum validates, under
a fleet with a liar and a flaky host -> differencing snapshots every 5
rounds (on the card, each diff snapshot's probe runs in the
``fused_delta_tiles`` kernel).

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.capsule import CapsuleSpec
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.elastic import SimWorker, VolunteerTrainer
from repro_torch.core.scheduler import SimClock, VolunteerScheduler
from repro_torch.core.server import Project, VBoincServer
from repro_torch.core.snapshots import SnapshotManager
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.distributed.sharding import init_tree
from repro_torch.launch.train import resolve_device
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw


def main(device="cuda", state=None) -> VolunteerTrainer:
    """Run the flow on ``device`` (``cuda`` needs a card); ``state``, where
    given, is the initial ``TrainState`` (else drawn from seed 0).
    -> the trainer, after its 30 rounds."""
    device = resolve_device(device)
    # ---- server side: publish the project ("VM image" + DepDisk manifest)
    store = ChunkStore()
    server = VBoincServer(store)
    spec = CapsuleSpec("granite-3-2b", "train_4k", RunConfig(remat="none"),
                       arch_override=reduced(get_arch("granite-3-2b")))
    server.publish(Project("quickstart-lm", spec,
                           dep_manifest={"disk": "optimizer-state"}))
    key = server.register_user("you")

    # ---- client side: fetch + verify the capsule
    fetched, missing, moved = server.fetch_capsule("quickstart-lm", set(), key)
    assert fetched.manifest_hash == spec.manifest_hash, "tampered capsule!"
    deps = server.probe_dependencies("quickstart-lm")
    print(f"capsule {fetched.manifest_hash[:12]} fetched "
          f"({moved} B moved); dependencies: {deps}")

    # ---- build the training job from the verified capsule spec
    cfg = fetched.arch
    run = fetched.run
    specs = api.state_specs(cfg)
    oc = adamw.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=400)
    grad_fn = api.make_grad_fn(api.make_eval_loss(cfg, run))

    def apply_fn(state, grads):
        p, o, _ = adamw.update(oc, grads, state.opt, state.params)
        return api.TrainState(p, o)

    if state is None:
        gen = torch.Generator(device=device).manual_seed(0)
        state = api.TrainState(init_tree(specs.params, gen, device=device),
                               init_tree(specs.opt, gen, device=device))
    trainer = VolunteerTrainer(
        grad_fn=grad_fn, apply_fn=apply_fn, state=state,
        stream=TokenStream(DataConfig(cfg.vocab_size, 32, 8, seed=0)),
        micro_batches=2,
        scheduler=VolunteerScheduler(replication=2, quorum=2,
                                     deadline_s=10.0, clock=SimClock()),
        snapshots=SnapshotManager(store, keep_last=2), snapshot_every=5)

    # ---- volunteers: one of them lies, one is flaky
    trainer.add_worker(SimWorker("honest-0"))
    trainer.add_worker(SimWorker("honest-1"))
    trainer.add_worker(SimWorker("liar", corrupt_prob=0.2,
                                 rng=np.random.default_rng(1)))
    trainer.add_worker(SimWorker("flaky", fail_prob=0.1,
                                 rng=np.random.default_rng(2)))
    trainer.respawn = lambda tr: tr.add_worker(
        SimWorker(f"fresh-{len(tr.workers)}"))

    for s in range(30):
        st = trainer.round(s)
        if s % 5 == 0 or s == 29:
            print(f"step {st.step:3d} loss {st.loss:.4f} "
                  f"(invalid results caught: {st.invalid}, "
                  f"snapshot bytes: {st.snapshot_bytes})")
    print(f"\nscheduler: {trainer.sched.stats}")
    credit = {w.worker_id: round(w.credit, 1)
              for w in trainer.sched.workers.values()}
    print(f"credit: {credit}")
    assert trainer.history[-1].loss < trainer.history[0].loss - 0.5
    print("OK: loss decreased under a faulty volunteer fleet.")
    return trainer


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    main(device=ap.parse_args().device)
