"""Batched serving engine: prefill + lockstep decode with ring-buffer KV
caches, greedy/temperature sampling, EOS handling, and throughput stats.
A PyTorch copy of ``repro/serve/engine.py``.

Static batching: up to ``max_batch`` equal-length prompts are admitted per
wave.  PyTorch runs eagerly, so there is nothing to compile per (B, S);
the host reads the sampled tokens back once per decode step, as the
reference does, to apply EOS and the per-request budgets.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    # filled by the engine:
    output: list = field(default_factory=list)
    done: bool = False


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0
    waves: int = 0

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Serves requests with ``model`` (a :class:`DecoderLM`) on the
    model's device.  Temperature sampling draws from a ``torch.Generator``
    on that device seeded with ``seed``."""

    def __init__(self, model, params, max_batch: int = 8,
                 max_len: int = 512, temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = ServeStats()

    # ---------------------------------------------------------- sampling ----

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    # ------------------------------------------------------------- serve ----

    def run(self, requests: list[Request]) -> list[Request]:
        """Process all requests in waves of ``max_batch``."""
        for i in range(0, len(requests), self.max_batch):
            self._run_wave(requests[i:i + self.max_batch])
        return requests

    def _run_wave(self, wave: list[Request]):
        B = len(wave)
        S = len(wave[0].prompt)
        if any(len(r.prompt) != S for r in wave):
            raise ValueError("static batching: equal prompt lengths per wave")
        prompts = torch.as_tensor(np.stack([r.prompt for r in wave]),
                                  dtype=torch.int64, device=self.device)

        _sync(self.device)
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(self.params, prompts,
                                            max_len=self.max_len)
        _sync(self.device)
        self.stats.prefill_s += time.perf_counter() - t0

        max_new = max(r.max_new_tokens for r in wave)
        done = np.zeros(B, bool)
        t0 = time.perf_counter()
        for step in range(max_new):
            tok = self._sample(logits)[:, None]
            tok_np = tok[:, 0].cpu().numpy()
            for b, r in enumerate(wave):
                if done[b]:
                    continue
                if step >= r.max_new_tokens or (
                        r.eos_id is not None and tok_np[b] == r.eos_id):
                    done[b] = True
                    r.done = True
                    continue
                r.output.append(int(tok_np[b]))
                self.stats.tokens_out += 1
            if done.all():
                break
            logits, caches = self.model.decode_step(self.params, tok, caches)
        _sync(self.device)
        self.stats.decode_s += time.perf_counter() - t0
        for r in wave:
            r.done = True
        self.stats.waves += 1
