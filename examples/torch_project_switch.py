"""DepDisk project switching on the PyTorch port: fine-tune TWO tasks off
one shared base model (the counterpart of ``examples/project_switch.py``).

The paper's §III-C claim: "when a user attaches to another BOINC project, a
new DepDisk need only be 'plugged in' … as opposed to downloading both a new
virtual machine image and DepDisk."  Here: the base disk holds the shared
pretrained params; each task's optimizer state lives in its own DepDisk.
Switching tasks = detach/attach; the base never moves again (chunk dedup
proves it: zero new bytes on re-snapshot).

    PYTHONPATH=src python examples/torch_project_switch.py           # card
    PYTHONPATH=src python examples/torch_project_switch.py --device cpu
"""
import argparse

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.depdisk import DiskSet
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.distributed.sharding import init_tree
from repro_torch.launch.train import resolve_device
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw


def main(device="cuda", state=None) -> DiskSet:
    """Run the flow on ``device`` (``cuda`` needs a card); ``state``, where
    given, is the base model's params (else drawn from seed 0).
    -> the disk set, after the switch and the resume."""
    device = resolve_device(device)
    cfg = reduced(get_arch("qwen2-1.5b"))
    run = RunConfig(remat="none", block_kv=16, ssm_chunk=8)
    specs = api.state_specs(cfg)
    params = state
    if params is None:
        params = init_tree(specs.params,
                           torch.Generator(device=device).manual_seed(0),
                           device=device)

    store = ChunkStore(chunk_bytes=1 << 14)
    disks = DiskSet(store, keep_last=2)
    base_info = disks.create_base(params)
    print(f"base disk (shared pretrained params): "
          f"{base_info.total_bytes / 1e6:.1f} MB, "
          f"{base_info.new_bytes / 1e6:.1f} MB stored")

    oc = adamw.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=200)
    grad_fn = api.make_grad_fn(api.make_eval_loss(cfg, run))

    def train_task(task: str, params, opt, seed: int, steps: int = 6):
        stream = TokenStream(DataConfig(cfg.vocab_size, 32, 8, seed=seed))
        for i in range(steps):
            loss, g = grad_fn(params, stream.batch(i))
            params, opt, _ = adamw.update(oc, g, opt, params)
        return float(loss), params, opt

    def fresh_opt(seed: int):
        return init_tree(specs.opt,
                         torch.Generator(device=device).manual_seed(seed),
                         device=device)

    # ---- task A: attach a fresh DepDisk ("fresh disk locally created")
    optA = fresh_opt(1)
    disks.attach_dep("taskA")
    lossA, paramsA, optA = train_task("A", params, optA, seed=10)
    infoA = disks.snapshot_disk("taskA", {"params": paramsA, "opt": optA},
                                step=0)
    print(f"taskA trained (loss {lossA:.3f}); DepDisk snapshot "
          f"{infoA.new_bytes / 1e6:.1f} MB")

    # ---- switch project: only the DepDisk changes hands
    disks.swap_task("taskA", "taskB")
    optB = fresh_opt(2)
    lossB, paramsB, optB = train_task("B", params, optB, seed=99)
    infoB = disks.snapshot_disk("taskB", {"params": paramsB, "opt": optB},
                                step=0)
    # base re-snapshot costs nothing: every chunk dedups
    base_again = disks.snapshot_disk("base", params, step=1)
    print(f"taskB trained (loss {lossB:.3f}); DepDisk snapshot "
          f"{infoB.new_bytes / 1e6:.1f} MB")
    print(f"base disk re-snapshot after switch: "
          f"{base_again.new_bytes} new bytes (all chunks deduped)")
    assert base_again.new_bytes == 0

    # ---- resume task A later from its DepDisk
    disks._attached["taskA"] = True
    got, _ = disks.restore_disk(
        "taskA", target_tree={"params": paramsA, "opt": optA}, device=device)
    assert torch.equal(tu.leaves(got["params"])[0], tu.leaves(paramsA)[0])
    print("taskA resumed bit-exactly from its DepDisk. OK")
    return disks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    main(device=ap.parse_args().device)
