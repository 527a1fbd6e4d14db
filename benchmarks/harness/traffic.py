"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a seed give every request of a run, the same for the same seed.

A mix of proofs has

- ``loop``: "closed" (a client sends its next proof when the last is done);
- ``clients``: the closed loop's clients (1: one proof at a time);
- ``stack_inputs``: the stack inputs of each proof, top first: ``count``
  values, each drawn as ``draw`` says ("field": uniform in [0, p));
- ``warm_proofs``: proofs made in set-up, before the window, so that the
  program's shape is ready (for the fused prover on the card: the eager
  proof, then the call that captures its graphs);
- ``window``: "replay" where every proof of the window has to be a replay
  of the shape's captured graphs on the card;
- ``profiled_proofs``: proofs made under the profiler after the window of a
  traced run.

Proof ``i`` of a part (``"warm"``, ``"window"``, ``"profiled"``) draws
from its own stream, so the inputs of a proof do not depend on how many
proofs came before it.
"""

from __future__ import annotations

import random

P = 2**64 - 2**32 + 1
DRAWS = {"field": lambda rng: rng.randrange(P)}


class Traffic:
    def __init__(self, mix: dict, seed: int):
        if mix["loop"] != "closed" or int(mix["clients"]) != 1:
            raise ValueError("the generator drives one closed-loop client")
        spec = mix["stack_inputs"]
        if spec["draw"] not in DRAWS or not 0 <= int(spec["count"]) <= 16:
            raise ValueError(f"stack inputs: {spec}")
        self.mix = mix
        self.seed = int(seed)

    def stack_inputs(self, part: str, i: int) -> list:
        """The stack inputs of proof ``i`` of ``part``, top first."""
        rng = random.Random(f"{self.seed}/{part}/{i}")
        spec = self.mix["stack_inputs"]
        draw = DRAWS[spec["draw"]]
        return [draw(rng) for _ in range(int(spec["count"]))] + [0] * (16 - int(spec["count"]))
