"""V-BOINC serving launcher (PyTorch port of ``repro.launch.serve``).

A request queue is batched, prefilled once (on the card, attention in the
flash-attention kernel and the selective scan in the ``ssm_scan``
kernel), then decoded token by token with the KV and SSM caches:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --prompt-len 32 --gen 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --device cpu

``--slots N`` serves the same prompts through the continuous-batching
``ServingEngine`` on ``N`` decode slots instead (decoder-only families,
greedy), and ``--telemetry DIR`` writes the telemetry hub's wall-clock
spans (the engine's ``engine.queue``, ``engine.admit``, ``engine.step``
and ``engine.step.dispatch``) as ``spans.jsonl``, with ``metrics.prom``,
into ``DIR`` at exit:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --slots 4 --requests 8 --telemetry /tmp/serve_tel --device cpu

The CLI serves ``reduced(get_arch(arch))``; ``build_server`` takes any
``ArchConfig`` (``chip_smoke.py`` passes granite-3-2b, falcon-mamba-7b,
hymba-1.5b, deepseek-moe-16b and seamless-m4t-medium at full width).  Runs on ``cuda`` unless
``--device cpu`` is given; with no GPU and no such request it stops with
an error.  On the card it takes the train launcher's deterministic
settings.  Sampling at ``--temperature`` > 0 draws from a
``torch.Generator`` seeded with ``--seed``, so its tokens differ from the
reference's ``jax.random`` draws; greedy decoding (the default) does not
sample.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig, get_arch, reduced
from repro_torch.core import telemetry as tlm
from repro_torch.distributed.sharding import init_tree
from repro_torch.launch.train import resolve_device
from repro_torch.models import api
from repro_torch.models.lm import RunConfig, cast_tree


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--slots", type=int, default=0,
                    help="serve through the continuous-batching "
                         "ServingEngine on this many decode slots "
                         "(decoder-only, greedy); 0 (default) prefills "
                         "every request as one batch")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write the telemetry hub's wall-clock spans "
                         "(spans.jsonl) and metrics.prom into DIR at exit")
    return ap.parse_args(argv)


@dataclass
class Server:
    """What ``build_server`` sets up and ``serve`` drives."""
    cfg: ArchConfig
    device: torch.device
    run: RunConfig
    params: dict          # in the compute dtype, cast once
    prefill: object
    decode: object


def build_server(cfg: ArchConfig, args: argparse.Namespace) -> Server:
    """Params from ``--seed`` on the device in the compute dtype, and the
    prefill and decode steps for prompts of ``--prompt-len`` plus
    ``--gen`` new tokens.

    Each leaf is drawn in float32 and cast before the next is drawn (the
    same generator and order as ``init_tree`` over the whole tree, so the
    same numbers): the peak is the bf16 tree plus the largest float32
    leaf, not both trees.  For deepseek-moe-16b that is 33.8 GB plus
    (28, 64, 2048, 1408) float32 experts, 20.7 GB, where the whole float32
    tree (67.5 GB) beside its bf16 copy would not fit in 80 GB."""
    device = resolve_device(args.device)
    run = RunConfig(remat="none", block_kv=128, ssm_chunk=32)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tu.tree_map(
        lambda spec: cast_tree(init_tree(spec, gen, device=device),
                               run.compute_dtype),
        api.param_specs(cfg))
    max_len = args.prompt_len + args.gen
    return Server(cfg, device, run, params,
                  api.make_prefill_step(cfg, max_len, run),
                  api.make_decode_step(cfg, run))


def _prompts(cfg: ArchConfig, args: argparse.Namespace, rng) -> np.ndarray:
    """``--requests`` prompts of ``--prompt-len`` random tokens."""
    return rng.integers(0, cfg.vocab_size,
                        (args.requests, args.prompt_len)).astype(np.int32)


def serve(server: Server, args: argparse.Namespace) -> dict:
    """Prefill ``--requests`` prompts of ``--prompt-len`` random tokens as
    one batch (an encoder–decoder's with as many random frames each,
    drawn after the prompts from the same generator, as the reference
    does), then decode ``--gen`` - 1 more tokens; -> summary."""
    cfg, dev = server.cfg, server.device
    rng = np.random.default_rng(args.seed)
    prompts = _prompts(cfg, args, rng)
    batch = {"tokens": prompts}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (args.requests, args.prompt_len, cfg.d_model)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def sample(lg):
        lg = lg[..., :cfg.vocab_size]
        if args.temperature <= 0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg.float() / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    sync()
    t0 = time.perf_counter()
    logits, caches = server.prefill(server.params, batch)
    sync()
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()

    tok = sample(logits)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, caches = server.decode(server.params, caches,
                                       {"tokens": tok,
                                        "index": args.prompt_len + i})
        finite &= torch.isfinite(logits).all()
        tok = sample(logits[:, 0])[:, None]
        generated.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    out_tokens = torch.cat(generated, dim=1).cpu().numpy()
    tps = args.requests * (args.gen - 1) / max(t_decode, 1e-9)
    summary = {
        "arch": cfg.name, "device": str(dev), "requests": args.requests,
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_tokens_per_s": tps,
        "logits_finite": bool(finite),
        "sample_output": out_tokens[0, :8].tolist(),
        "tokens": out_tokens.tolist(),
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "tokens"},
                     indent=2))
    return summary


def serve_engine(server: Server, args: argparse.Namespace) -> dict:
    """Serve the same ``--requests`` prompts through ``ServingEngine`` on
    ``--slots`` slots, ``--gen`` greedy tokens each, admitted as slots
    free; -> summary."""
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = server.cfg
    prompts = _prompts(cfg, args, np.random.default_rng(args.seed))
    engine = ServingEngine(cfg, server.params, slots=args.slots,
                           max_len=args.prompt_len + args.gen,
                           run=server.run)
    t0 = time.perf_counter()
    done = engine.run_queue([Request(i, p, args.gen)
                             for i, p in enumerate(prompts)])
    t_run = time.perf_counter() - t0
    done.sort(key=lambda r: r.request_id)
    tokens = [r.output for r in done]
    summary = {
        "arch": cfg.name, "device": str(server.device),
        "requests": args.requests, "slots": args.slots, "run_s": t_run,
        "decode_steps": engine.stats["decode_steps"],
        "tokens_per_s": sum(map(len, tokens)) / max(t_run, 1e-9),
        "ttft_max_s": max(r.first_token_s for r in done),
        "sample_output": tokens[0][:8],
        "tokens": tokens,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "tokens"},
                     indent=2))
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = reduced(get_arch(args.arch))
    if args.slots and (cfg.enc_dec or args.temperature > 0):
        raise SystemExit("--slots serves decoder-only families greedily")
    tel_dir = Path(args.telemetry) if args.telemetry else None
    if tel_dir is not None:
        tel_dir.mkdir(parents=True, exist_ok=True)
        tlm.set_default(tlm.Telemetry())
    server = build_server(cfg, args)
    summary = (serve_engine if args.slots else serve)(server, args)
    if tel_dir is not None:
        tel = tlm.get_default()
        tel.dump_spans_jsonl(tel_dir / "spans.jsonl")
        (tel_dir / "metrics.prom").write_text(tel.prometheus())
    return summary


if __name__ == "__main__":
    main()
