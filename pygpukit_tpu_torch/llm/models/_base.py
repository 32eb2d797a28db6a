"""What the families with ONE per-layer cache tree share (counterpart of
``pygpukit_tpu/llm/models/_base.py``): Mamba (``mamba.py``) and LFM2
(``lfm2.py``) carry their caches as a list of per-layer dicts (conv
tails, SSM states, fixed K/V caches side by side), where DeepSeek and
gpt-oss carry two stacked tensors (``_standalone.generate_chunked``).

- The math helpers the families share: ``mm`` (``llm.model._mm``: bf16
  operands on the card through cuBLAS's bf16 product, anything else as an
  f32 product, TF32 off by ``core.backend.set_deterministic_numerics``),
  the per-head RMS norm, causal attention within a padded block, the
  depthwise causal conv and its decode state, the f32 head.
- ``StandaloneCachedModel``: the single-tree caches, the bucketed prefill
  (a power of two, 16 at least), the stateful blocked prefill and the
  chunked greedy ``generate``, every program captured once in the model's
  ``graphs`` and replayed (``core.executable``).

A family's hooks work in place: ``_prefill_fn(cfg, params, caches, tokens,
true_len)`` and ``_decode_step_fn(cfg, params, caches, token, pos)`` write
the caches they are given and return ``(caches, logits)``, and
``_generate_scan_fn(cfg, n_steps, params, caches, token, pos)`` returns the
int32 tokens; ``true_len``, ``token`` and ``pos`` are ints or one-element
int32 device tensors, never read on the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ...core.backend import resolve_device
from ...core.executable import ExecutableCache
from ...ops.nn import rmsnorm_fn
from ..model import _last_row as last_row
from ..model import _mm, sample_logits
from ._standalone import head_logits

_F32 = torch.float32
_NEG_INF = -1e30


#: the products, the per-head RMS norm (Qwen3's q_norm/k_norm shape) and
#: the f32 head are the dense families' own
mm = _mm
qk_headnorm = rmsnorm_fn
lm_head = head_logits


def attn_block_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      true_len) -> torch.Tensor:
    """Causal attention in f32 within a padded block: q [S, Hq, D], k/v
    [S, Hk, D] (GQA by repeating each kv head over its group), keys at or
    past ``true_len`` masked. [S, Hq * D] in q's dtype."""
    s, hq, d = q.shape
    hk = k.shape[1]
    if hk != hq:
        k = torch.repeat_interleave(k, hq // hk, dim=1)
        v = torch.repeat_interleave(v, hq // hk, dim=1)
    qh, kh, vh = (t.permute(1, 0, 2).to(_F32) for t in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(1, 2)) / math.sqrt(d)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j > i) | (j >= true_len)
    scores = torch.where(mask, torch.full_like(scores, _NEG_INF), scores)
    out = torch.matmul(torch.softmax(scores, dim=-1), vh)
    return out.permute(1, 0, 2).reshape(s, hq * d).to(q.dtype)


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """Depthwise causal conv of x [S, C] with kernel w [C, K] (the newest
    input multiplies the LAST column), f32, no activation: out[s] = sum_j
    w[:, j] * x[s - (K - 1) + j], summed in ascending j."""
    s, k = x.shape[0], w.shape[1]
    xp = torch.nn.functional.pad(x.to(_F32), (0, 0, k - 1, 0))
    wf = w.to(_F32)
    out = torch.zeros(x.shape, dtype=_F32, device=x.device)
    for j in range(k):
        out = out + xp[j:j + s] * wf[:, j]
    if bias is not None:
        out = out + bias.to(_F32)
    return out


def conv_state_tail(x: torch.Tensor, true_len, k: int, dtype: torch.dtype) -> torch.Tensor:
    """The last ``k`` valid rows of x [S, C] right-aligned as [C, k] (the
    decode conv state), zeros where ``true_len < k`` (transformers'
    left pad). ``true_len`` an int or a one-element device tensor."""
    s = x.shape[0]
    start = true_len - k
    if isinstance(start, torch.Tensor):
        start = start.reshape(()).to(torch.long)
    idx = start + torch.arange(k, device=x.device)
    rows = x[torch.clamp(idx, 0, s - 1)]
    rows = torch.where((idx >= 0)[:, None], rows, torch.zeros_like(rows))
    return rows.t().to(dtype)


def greedy_scan(step_fn, cfg, n_steps: int, p: dict, caches, token, pos) -> torch.Tensor:
    """``n_steps`` greedy steps of ``step_fn(cfg, p, caches, token, pos)``
    from ``token`` at ``pos``; int32 tokens [n_steps] on the device."""
    out, tok = [], token
    for i in range(n_steps):
        _, logits = step_fn(cfg, p, caches, tok, pos + i)
        tok = sample_logits(logits).to(torch.int32).reshape(1)
        out.append(tok)
    return torch.cat(out)


def _pow2(n: int, least: int) -> int:
    return max(1 << (n - 1).bit_length(), least)


class StandaloneCachedModel:
    """Chunked greedy generation over one per-layer cache tree (module
    docstring). A subclass sets ``config``, ``params`` and ``dtype``, then
    calls ``_setup()``, and gives the hooks ``_prefill_fn``,
    ``_generate_scan_fn``, ``_forward_fn(cfg, params, tokens)``,
    ``_init_caches(cfg, max_seq_len, dtype, device)``, ``_decode_step_fn``
    (which ``llm.serving_hybrid`` serves) and ``_name``."""

    _prefill_fn = None
    _generate_scan_fn = None
    _forward_fn = None
    _init_caches = None
    _decode_step_fn = None
    #: the prefill CONTINUES from the caches it is given (zero caches: from
    #: scratch), so a long prompt may stream through it in blocks of
    #: ``_prefill_block`` tokens, bounding the working set of a recurrence
    #: whose parallel scan holds [S, ...] operands (Mamba's [S, E, N])
    _stateful_prefill = False
    _prefill_block: int | None = None
    _name = "model"

    def _setup(self) -> None:
        self.caches = None
        self.max_seq_len: int | None = None
        self.pos = 0
        self.graphs = ExecutableCache(shared_pool=True)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """f32 logits [S, V] of the uncached forward."""
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(-1))
        return type(self)._forward_fn(self.config, self.params, ids.to(self.device))

    def get_logits(self, input_ids) -> np.ndarray:
        return self.forward(input_ids).cpu().numpy().astype(np.float32, copy=False)

    def init_fixed_cache(self, max_seq_len: int) -> None:
        """Zeroed caches for ``max_seq_len`` positions, position 0; the
        captured programs are released."""
        self.graphs.reset()
        self.caches = type(self)._init_caches(self.config, max_seq_len, self.dtype,
                                              resolve_device(self.device))
        self.max_seq_len = max_seq_len
        self.pos = 0

    def _replay_prefill(self, ids: np.ndarray) -> torch.Tensor:
        """One prefill of ``ids`` padded to its bucket, through the bucket's
        captured program (the caches donated, the weights bound). Returns
        the f32 logits of the last token, a static output."""
        n = len(ids)
        bucket = _pow2(n, 16)
        dev = self.device
        exe = self.graphs.get_or_capture(
            ("prefill", bucket), functools.partial(type(self)._prefill_fn, self.config),
            self.params, self.caches, torch.zeros(bucket, dtype=torch.int32, device=dev), 1,
            donate_argnums=(1,), bound_argnums=(0,), name=f"{self._name}_prefill_{bucket}")
        padded = torch.zeros(bucket, dtype=torch.int32)
        padded[:n] = torch.from_numpy(np.asarray(ids, np.int64))
        _, logits = exe.replay(self.params, self.caches, padded.to(dev), n)
        return logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, chunk_size: int = 64,
                 prefill_block: int | None = None) -> list[int]:
        """Greedy generation: a cache of the next power of two past the run
        (64 at least) when the model has none, the prompt through the
        bucketed prefill (a stateful family's prompt longer than
        ``prefill_block``, else ``_prefill_block``, in blocks of that many
        tokens, each continuing the last), the first token taken on the
        device, then captured chunks of up to ``chunk_size`` steps with one
        host read each. A stateful family's caches are zeroed first, so a
        run never continues the previous one's state."""
        cls = type(self)
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        n = len(ids)
        if self.caches is None:
            self.init_fixed_cache(_pow2(n + max_new_tokens + 1, 64))
        blk = prefill_block if prefill_block is not None else cls._prefill_block
        if cls._stateful_prefill:
            for leaf in pytree.tree_leaves(self.caches):
                leaf.zero_()
        if cls._stateful_prefill and blk and n > blk:
            for off in range(0, n, blk):
                logits = self._replay_prefill(ids[off:off + blk])
        else:
            logits = self._replay_prefill(ids)
        self.pos = n
        cur = torch.argmax(logits).to(torch.int32).reshape(1)
        out: list[int] = []
        first = True
        while len(out) < max_new_tokens:
            steps = min(max_new_tokens - len(out) - (1 if first else 0), chunk_size,
                        self.max_seq_len - self.pos)
            if steps <= 0:
                if first:
                    out.append(int(cur))
                break
            exe = self.graphs.get_or_capture(
                ("generate", steps), functools.partial(cls._generate_scan_fn, self.config,
                                                       steps),
                self.params, self.caches, 0, 0, donate_argnums=(1,), bound_argnums=(0,),
                name=f"{self._name}_generate_{steps}")
            toks = exe.replay(self.params, self.caches, cur, self.pos)
            self.pos += steps
            if first:
                toks = torch.cat([cur, toks])
                first = False
            out.extend(toks.tolist())
            cur = toks[-1:].to(torch.int32)
        return out[:max_new_tokens]
