"""Driver of the training cells: V-BOINC's volunteer round.

Set-up builds the session ``repro_torch.launch.train.build_trainer``
returns for the traffic's flags, puts the benchmark's seeded weights into
its state, and drives the first ``setup_rounds`` rounds through
``VolunteerTrainer.round``, the window's own call, on its own feed.
Those rounds are the steps the reference follows, and they take the
first (full) snapshot and the first differencing one, so that the window
runs warm and its snapshots are deltas, as in a long job.  The window
then calls ``round`` until ``--seconds`` have passed.

``train_tokens_per_s`` counts every token of the rounds that completed in
the window, in whole snapshot periods (``snapshot_every`` rounds, each
with one snapshot), over the time from its start to the end of the last
of them; snapshot stalls fall inside it.

The check: the program's first three steps against the plain reference
(loss of each round, the first gradient as AdamW got it, by its norms and
element by element, the parameters' change after the three), and, where the cell snapshots, the state
restored from the window's newest snapshot against the live state of that
round, bit for bit (a fingerprint of each leaf's words).
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from vbench import costs, stats, weights
from vbench.harness import Run
from vbench.reference import families
from vbench.reference import train as ref_train
from vbench.reference.precision import F32, Precision, no_tf32

FOLLOWED = 3          # steps the reference follows
SILENT = 1e-3         # a leaf whose reference gradient is under this share
                      # of the median leaf's is left out of the change


def arch_config(c: dict):
    """The program's ``ArchConfig`` for a configuration file: the port's
    ``arch``, which has to be of the family's ``PROGRAM_FAMILY``, with the
    fields the family's file gives (``arch_fields``; a nested config's as
    a dict of its own)."""
    from repro_torch.configs.base import get_arch
    fam = families.of(c)
    base = get_arch(c["arch"])
    if base.family != fam.PROGRAM_FAMILY:
        raise SystemExit(f"vbench: {c['arch']} is {base.family}, family "
                         f"{c['family']} runs {fam.PROGRAM_FAMILY}")
    kw = {k: dataclasses.replace(getattr(base, k), **v)
          if isinstance(v, dict) else v
          for k, v in fam.arch_fields(c).items()}
    return dataclasses.replace(base, **kw)


def state_keys(tree) -> list:
    from repro_torch import tree as tu
    return tu.flatten_with_keys(tree)


def fingerprint(tree_items) -> dict:
    """{key: (sum, sum of squares)} of each leaf's 32-bit words as int64,
    wrapping: equal bits give equal prints."""
    out = {}
    for k, x in tree_items:
        v = x.detach().reshape(-1)
        if v.element_size() == 4:
            v = v.view(torch.int32)
        v = v.to(torch.int64)
        out[k] = torch.stack([v.sum(), (v * v).sum()])
    return out


class Session:
    """What set-up hands the window and the check."""

    def __init__(self, run: Run, device):
        from repro_torch.launch import train
        c, tr = run.cell.config, run.cell.traffic
        self.run, self.device = run, device
        self.c, self.tr = c, tr
        self.cfg = arch_config(c)
        if tr["snapshot_every"] and tr["setup_rounds"] % tr["snapshot_every"]:
            raise SystemExit("vbench: setup_rounds must end a snapshot "
                             "period, so that the window starts one")
        o = tr["optimizer"]
        flags = ["--arch", c["arch"], "--seq", str(tr["seq"]),
                 "--batch", str(tr["batch"]), "--micro", str(tr["micro"]),
                 "--workers", str(tr["workers"]),
                 "--replication", str(tr["replication"]),
                 "--quorum", str(tr["quorum"]),
                 "--snapshot-every", str(tr["snapshot_every"]),
                 "--steps", str(o["total_steps"] // 2), "--lr", str(o["lr"]),
                 "--seed", str(run.seed), "--device", device.type]
        if tr.get("async_writer"):
            flags.append("--async-writer")
        self.args = train.parse_args(flags)
        self.sess = train.build_trainer(self.cfg, self.args)
        self.trainer = self.sess.trainer
        self.shapes = {k: tuple(x.shape)
                       for k, x in state_keys(self.trainer.state.params)}
        w = weights.make(c, self.shapes, run.seed, device, torch.float32)
        with torch.no_grad():
            for k, x in state_keys(self.trainer.state.params):
                x.copy_(w[k])
        del w
        self.losses, self.first_grad, self.change = [], None, None
        self.first_grad_t = None
        self.printed = (None, {})   # (round, fingerprint) of the newest
        self.step = 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def first_steps(self) -> None:
        """Rounds 0 .. setup_rounds-1: the reference follows the first
        three; the program's first gradient is read off AdamW's first
        moment after round 0 (m = (1 - beta1) g), its change after round 2."""
        b1 = self.tr["optimizer"]["beta1"]
        took = self.run.facts.setdefault("setup_round_s", [])
        for s in range(self.tr["setup_rounds"]):
            t = time.perf_counter()
            st = self.trainer.round(s)
            self.sync()
            took.append(time.perf_counter() - t)
            if st.snapshot_stall_ms:
                self.printed = (s, fingerprint(state_keys(self.trainer.state)))
            self.step = s + 1
            if s < FOLLOWED:
                self.losses.append(st.loss)
            if s == 0:
                # kept on the host, out of the window's device memory
                self.first_grad_t = {
                    ref_train.dotted(k): x.detach().to("cpu") / (1 - b1)
                    for k, x in state_keys(self.trainer.state.opt.m)}
                self.first_grad = ref_train.split_norms(self.first_grad_t)
            if s == FOLLOWED - 1:
                w0 = weights.make(self.c, self.shapes, self.run.seed,
                                  self.device, torch.float32)
                self.change = ref_train.split_norms({
                    ref_train.dotted(k): x - w0[k]
                    for k, x in state_keys(self.trainer.state.params)})
                del w0
        t = time.perf_counter()
        self.sess.snaps.wait()
        self.sync()
        self.run.facts["setup_drain_s"] = time.perf_counter() - t

    @property
    def snapshots(self) -> bool:
        return bool(self.tr["snapshot_every"])


def setup(run: Run, device) -> Session:
    ses = Session(run, device)
    ses.first_steps()
    return ses


def window(ses: Session, run: Run) -> None:
    """Rounds until ``run.seconds`` have passed; the spans the per-layer
    metrics read are recorded in a traced run."""
    from repro_torch.core import elastic
    from repro_torch.kernels.delta_encode import ops as delta_ops
    trainer, spans = ses.trainer, run.spans
    tokens = ses.tr["micro"] * ses.tr["batch"] * ses.tr["seq"]
    restore = []
    if run.trace:
        def patch(obj, name, new):
            restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)

        def delta_call(args, out):
            run.call("fused_delta_tiles", nblk=int(args[0].shape[0]),
                     changed=out[0].sum())
        patch(trainer, "grad_fn",
              spans.wrap("model.grad_fn", trainer.grad_fn, ses.sync))
        patch(elastic, "grad_hash",
              spans.wrap("trainer.grad_hash", elastic.grad_hash))
        patch(delta_ops, "fused_delta_tiles",
              spans.wrap("kernel.fused_delta_tiles",
                         delta_ops.fused_delta_tiles, after=delta_call))
    ends, work = [], []
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    try:
        while time.perf_counter() < t_end:
            s0 = time.perf_counter()
            st = trainer.round(ses.step)
            ses.sync()
            s1 = time.perf_counter()
            spans.add("trainer.round", s0, s1)
            ends.append(s1)
            work.append(tokens)
            if st.snapshot_stall_ms:
                spans.count("snapshot_stall_ms", st.snapshot_stall_ms)
                spans.add("snapshot.stall", s1 - st.snapshot_stall_ms / 1e3,
                          s1)
                ses.printed = (ses.step, fingerprint(state_keys(trainer.state)))
            if st.loss != st.loss:
                run.failed += 1
            ses.step += 1
    finally:
        for obj, name, old in reversed(restore):
            setattr(obj, name, old)
    period = ses.tr["snapshot_every"] or 1
    rate, done, secs = stats.completed_rate(t0, ends, work, t_end, period)
    # the per-layer readings take every round the loop ran, the last one
    # too, which ends after t_end
    run.window = (t0, time.perf_counter())
    run.attempted = len(ends)
    run.e2e["train_tokens_per_s"] = rate
    run.facts.update(tokens_done=done, seconds_done=secs,
                     rounds_done=round(done / tokens),
                     units_per_round=ses.tr["micro"],
                     flops_per_unit=costs.train_flops(
                         ses.c, ses.tr["batch"], ses.tr["seq"]))
    for call in run.kernel_calls.get("fused_delta_tiles", []):
        call.update(costs.delta_work(call["nblk"], int(call["changed"])))


def rel_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def diff_gap(prog_t: dict, ref_t: dict, ref_norms: dict) -> float:
    """The worst leaf's norm of the difference between the program's
    first gradient and the reference's, element by element, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    dev = next(iter(ref_t.values())).device
    diff = ref_train.split_norms({k: prog_t[k].to(dev) - ref_t[k]
                                  for k in ref_t})
    med = statistics.median(ref_norms.values())
    return max(diff[k] / max(ref_norms[k], med) for k in diff)


def readings(got: dict, ref: dict) -> dict:
    """The numbers compared: ``got`` and ``ref`` each hold ``losses``,
    ``first_grad`` (and its tensors, ``first_grad_t``) and ``change``.
    Leaves whose reference gradient is nought to rounding (under
    ``SILENT`` of the median leaf's) move under AdamW by round-off alone
    and are left out of the change."""
    g_ref, d_ref = ref["first_grad"], ref["change"]
    keys = sorted(g_ref)
    med = statistics.median(g_ref[k] for k in keys)
    moving = [k for k in keys if g_ref[k] >= SILENT * med]
    return {
        "loss_gap": max(abs(a - b) / b for a, b in zip(got["losses"],
                                                        ref["losses"])),
        "grad_norm_gap": rel_gap(got["first_grad"], g_ref, keys),
        "grad_diff": diff_gap(got["first_grad_t"], ref["first_grad_t"],
                              g_ref),
        "change_gap": rel_gap(got["change"], d_ref, moving),
    }


def reference(ses: Session, prec: Precision) -> dict:
    c, tr, seed = ses.c, ses.tr, ses.run.seed
    rounds = [[ref_train.token_batch(c["vocab_size"], tr["seq"], tr["batch"],
                                     seed, r * tr["micro"] + u)
               for u in range(tr["micro"])] for r in range(FOLLOWED)]
    w = weights.make(c, ses.shapes, seed, ses.device, torch.float32)
    w0 = {ref_train.dotted(k): x for k, x in w.items()}
    opt = dict(tr["optimizer"])
    with no_tf32():
        return ref_train.follow(c, w0, rounds, opt, prec)


def check(ses: Session, run: Run, control: Precision = None) -> dict:
    """Fill ``run.checks``; -> the readings (and the control's)."""
    if ses.snapshots:
        snaps = ses.sess.snaps
        snaps.wait()
        step, want = ses.printed
        restored, _ = snaps.restore(device=ses.device)
        got = fingerprint(sorted(restored.items()))
        if step != snaps.get_manifest(snaps.latest()).step:
            want = {}              # no print of the newest snapshot's round
        differ = sum(1 for k in got.keys() | want.keys()
                     if k not in got or k not in want
                     or not torch.equal(got[k], want[k]))
        run.check("snapshot_leaves_differing", differ, 0)
        del restored
    ses.sess.snaps.close()
    del ses.sess, ses.trainer
    gc.collect()
    if ses.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(ses, F32)
    got = readings({"losses": ses.losses, "first_grad": ses.first_grad,
                    "first_grad_t": ses.first_grad_t,
                    "change": ses.change}, ref)
    for k, v in got.items():
        run.check(k, v, run.cell.limits[k])
    if control is None:
        return got
    return {"program": got, "control": readings(reference(ses, control), ref)}
