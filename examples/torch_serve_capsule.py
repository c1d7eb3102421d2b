"""Batched serving inside a capsule on the PyTorch port: prefill once,
decode with caches, with capsule-level suspend/resume (the
boinccmd-vs-controlvm split) mid-stream (the counterpart of
``examples/serve_capsule.py``).  On the card each layer's prefill scan
runs in the ``ssm_scan`` kernel.

    PYTHONPATH=src python examples/torch_serve_capsule.py            # card
    PYTHONPATH=src python examples/torch_serve_capsule.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.control import CapsuleRuntime, HostSupervisor
from repro_torch.distributed.sharding import init_tree
from repro_torch.launch.train import resolve_device
from repro_torch.models import api
from repro_torch.models.lm import RunConfig


def main(device="cuda", state=None) -> np.ndarray:
    """Run the flow on ``device`` (``cuda`` needs a card); ``state``, where
    given, is the params (else drawn from seed 0).  -> the generated
    tokens, (requests, new tokens)."""
    device = resolve_device(device)
    cfg = reduced(get_arch("falcon-mamba-7b"))     # attention-free decode
    run = RunConfig(remat="none", block_kv=64, ssm_chunk=16)
    params = state
    if params is None:
        params = init_tree(api.param_specs(cfg),
                           torch.Generator(device=device).manual_seed(0),
                           device=device)

    B, PROMPT, GEN = 4, 24, 12
    MAX = PROMPT + GEN
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)

    runtime = CapsuleRuntime("serve-0")
    sup = HostSupervisor("host-0", runtime)
    sup.control_vm("startvm")

    prefill = api.make_prefill_step(cfg, MAX, run)
    decode = api.make_decode_step(cfg, run)

    logits, caches = prefill(params, {"tokens": prompts})
    tok = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)[:, None]
    out = [tok.cpu().numpy()]
    for i in range(GEN - 1):
        if i == GEN // 2:                       # operator pauses the VM
            sup.control_vm("pause")
            assert not runtime.accepting_work
            sup.control_vm("unpause")           # ... and resumes; caches
            assert runtime.accepting_work       # live on, nothing is lost
        logits, caches = decode(params, caches,
                                {"tokens": tok, "index": PROMPT + i})
        tok = torch.argmax(logits[:, 0, :cfg.vocab_size], -1) \
            .to(torch.int32)[:, None]
        out.append(tok.cpu().numpy())
    gen = np.concatenate(out, axis=1)
    print(f"served {B} requests, generated {gen.shape[1]} tokens each")
    print("first request tokens:", gen[0].tolist())
    print("runtime log:", runtime.log)
    return gen


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    main(device=ap.parse_args().device)
