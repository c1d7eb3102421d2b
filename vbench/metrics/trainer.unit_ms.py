"""Wall ms per unit of ``VolunteerTrainer.round`` outside ``grad_fn`` and
the snapshot call: the quorum hash, the scheduler, the fold and AdamW."""
from vbench.readouts import covered, spans_in_window


def read(run):
    rounds = spans_in_window(run, "trainer.round")
    grads = spans_in_window(run, "model.grad_fn")
    if not rounds or not grads:
        return None
    stalls = spans_in_window(run, "snapshot.stall")
    outside = sum((e - s) - covered(grads, s, e) - covered(stalls, s, e)
                  for s, e in rounds)
    return outside / (len(rounds) * run.facts["units_per_round"]) * 1e3
