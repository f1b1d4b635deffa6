"""Decode engine over the two-tier paged KV pool.

Supports decoder-only attention LMs (single homogeneous group, no SWA for
the paged path).  A decode step walks the model's blocks, scatters the new
token's K/V into its page slot, and calls the paged-attention wrapper:
the hand-written CUDA kernel on the card, its plain version on the CPU.
Everything runs under ``torch.no_grad()``: serving is forward-only.

Pond integration per step:
  * access-bit telemetry on pages (AccessBitScanner),
  * zNUMA spill stats -> virtual step latency via the tier model
    (pool-touched fraction slows the step, core/latency_model.py),
  * QoS monitor: sequences whose pool-traffic fraction exceeds the PDM
    knee get migrated local (kv.migrate_seq_to_local, 50ms/GB).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.latency_model import TierModel, migration_seconds
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_rope, rope_cos_sin
from repro_torch.models.transformer import LM
from repro_torch.serving.kv_cache import KVConfig, TieredPagedKV
from repro_torch.serving.scheduler import ContinuousBatcher, Request


def paged_kv_config(cfg: ArchConfig, page_size: int = 16,
                    num_local: int = 256, num_pool: int = 256,
                    dtype: str = "float32") -> KVConfig:
    return KVConfig(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                    page_size, num_local, num_pool, dtype)


def _paged_blocks(model: LM):
    cfg = model.cfg
    assert len(cfg.groups) == 1 and cfg.groups[0].blocks[0].mixer == "attn"
    assert len(cfg.groups[0].blocks) == 1 and cfg.sliding_window is None
    assert cfg.groups[0].blocks[0].ffn == "mlp"     # as the reference's MLP
    return model.blocks()


def make_paged_decode_step(model: LM, page_size: int):
    """(k_pool, v_pool, tables, lens, tokens) -> logits (B,1,V) fp32.

    pools: (L, Hkv, P, page, D); tables: (B, maxp); lens: (B,) current
    lengths INCLUDING the new token (write slot = lens-1).  The pools are
    updated in place, where the reference donates them to its jitted step
    and takes new ones back.
    """
    cfg = model.cfg
    blocks = _paged_blocks(model)

    @torch.no_grad()
    def step(k_pool, v_pool, tables, lens, tokens):
        b = tokens.shape[0]
        positions = lens - 1                             # 0-based slot
        x = model.embed(tokens)                          # (B,1,d)
        page_of = (positions // page_size).long()        # (B,)
        page_ids = tables.gather(1, page_of[:, None])[:, 0].long()
        offs = (positions % page_size).long()
        cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim,
                                cfg.rope_theta)          # same for all layers
        for li, blk in enumerate(blocks):
            q, k, v = blk.mixer.project_qkv(blk.norm1(x))
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            # scatter the new token into its page slot before attending:
            # layer views are (Hkv, P, page, D), values (Hkv, B, D)
            kpl, vpl = k_pool[li], v_pool[li]
            kpl[:, page_ids, offs] = k[:, 0].transpose(0, 1).to(kpl.dtype)
            vpl[:, page_ids, offs] = v[:, 0].transpose(0, 1).to(vpl.dtype)
            out = pa_ops.paged_attention(
                q[:, 0].to(kpl.dtype).contiguous(), kpl, vpl, tables, lens,
                scale=cfg.head_dim ** -0.5)
            out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(x.dtype)
            x = x + blk.mixer.project_out(out)
            x = x + blk.ffn(blk.norm2(x))
        return model.logits(model.final_norm(x))

    return step


def make_paged_prefill_fill(model: LM, page_size: int):
    """Fill pools from a prompt (one sequence), in place: (k_pool, v_pool,
    tokens (1,S), page_ids (npages,)) -> last-position logits (1,1,V).
    Runs the normal prefill math; K/V per layer scattered to pages."""
    cfg = model.cfg
    blocks = _paged_blocks(model)

    @torch.no_grad()
    def fill(k_pool, v_pool, tokens, page_ids):
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device)[None]
        x = model.embed(tokens)
        npages = page_ids.shape[0]
        pad = npages * page_size - s
        page_ids = page_ids.long()
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

        def to_pages(t):                     # (S,Hkv,D) -> (Hkv,np,page,D)
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
            return t.reshape(npages, page_size, cfg.num_kv_heads,
                             cfg.head_dim).permute(2, 0, 1, 3)

        for li, blk in enumerate(blocks):
            q, k, v = blk.mixer.project_qkv(blk.norm1(x))
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            kpl, vpl = k_pool[li], v_pool[li]
            kpl[:, page_ids] = to_pages(k[0]).to(kpl.dtype)
            vpl[:, page_ids] = to_pages(v[0]).to(vpl.dtype)
            out = attn_mod._self_attention(q, k, v, cfg, positions, True,
                                           "blocked")
            x = x + blk.mixer.project_out(out)
            x = x + blk.ffn(blk.norm2(x))
        return model.logits(model.final_norm(x[:, -1:]))

    return fill


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens: int = 0
    virtual_seconds: float = 0.0
    migrations: int = 0
    migration_seconds: float = 0.0
    pool_traffic_fracs: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EngineTimings:
    """Host-clock seconds of the device work, one entry per call.  Each
    interval ends after the token ids have been copied to the host, which
    waits for the device, so it covers the whole step.  Kept apart from
    ``EngineStats``, which must not depend on the machine."""
    prefill_seconds: list = dataclasses.field(default_factory=list)
    decode_seconds: list = dataclasses.field(default_factory=list)


class DecodeEngine:
    def __init__(self, model: LM, kv_cfg: KVConfig,
                 max_batch: int = 8, pdm: float = 0.05,
                 tier_model: TierModel | None = None, slice_pool=None):
        """The KV pool is made on the model's device."""
        self.model = model
        self.device = model.device
        self.kv = TieredPagedKV(kv_cfg, slice_pool=slice_pool,
                                device=self.device)
        self.batcher = ContinuousBatcher(max_batch)
        self.tier = tier_model or TierModel()
        self.pdm = pdm
        self.page_size = kv_cfg.page_size
        self._decode = make_paged_decode_step(model, kv_cfg.page_size)
        self._prefill = make_paged_prefill_fill(model, kv_cfg.page_size)
        self.stats = EngineStats()
        self.timings = EngineTimings()
        self.outputs: dict[int, list[int]] = {}
        self._next_tokens: dict[int, int] = {}
        self._prompts: dict[int, np.ndarray] = {}
        # stays True while every logit the engine produced was finite;
        # kept on the device so that checking it costs no host round trip
        self.logits_finite = torch.ones((), dtype=torch.bool,
                                        device=self.device)

    # ------------------------------------------------------------ admission
    def submit(self, req: Request, prompt_tokens):
        self._prompts[req.req_id] = np.asarray(prompt_tokens)
        self.batcher.submit(req)

    def _admit(self):
        def can(req):
            return self.kv.can_admit(req.prompt_len, req.max_new_tokens)
        for req in self.batcher.admit(can):
            # `pages` IS the list stored in kv.tables[req_id]: the tail
            # reservation below grows the sequence's table through it
            pages = self.kv.admit(req.req_id, req.prompt_len)
            # reserve tail pages up-front (GB-aligned zNUMA sizing)
            while len(pages) < self.kv.pages_for(req.prompt_len
                                                 + req.max_new_tokens):
                pages.append(self.kv.alloc.alloc())
            t0 = time.perf_counter()
            toks = torch.from_numpy(
                self._prompts[req.req_id].astype(np.int64))[None]
            logits = self._prefill(
                self.kv.k, self.kv.v, toks.to(self.device),
                torch.tensor(pages, dtype=torch.int32, device=self.device))
            self.logits_finite &= torch.isfinite(logits).all()
            nxt = int(torch.argmax(logits[0, -1]))
            self.timings.prefill_seconds.append(time.perf_counter() - t0)
            self._next_tokens[req.req_id] = nxt
            self.outputs[req.req_id] = [nxt]

    # ------------------------------------------------------------ stepping
    def step(self) -> int:
        """One continuous-batching decode step; returns #active seqs."""
        self._admit()
        ids = self.batcher.active_ids
        if not ids:
            return 0
        for s in ids:
            self.kv.extend(s)
        t0 = time.perf_counter()
        tbl, lens = self.kv.batch_tables(ids)
        toks = torch.tensor([[self._next_tokens[s]] for s in ids],
                            dtype=torch.int64, device=self.device)
        logits = self._decode(self.kv.k, self.kv.v, tbl, lens, toks)
        self.logits_finite &= torch.isfinite(logits).all()
        # greedy: the first maximum, taken on the device; only the (B,)
        # token ids cross to the host
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        self.timings.decode_seconds.append(time.perf_counter() - t0)

        # ---- Pond telemetry + QoS --------------------------------------
        self.kv.record_touches(ids)
        spill = self.kv.spill_stats(ids)
        self.stats.pool_traffic_fracs.append(spill["pool_traffic_frac"])
        step_s = 1e-3 * self.tier.slowdown_factor(
            spill["pool_traffic_frac"])
        self.stats.virtual_seconds += step_s
        self.stats.steps += 1
        self.stats.tokens += len(ids)
        for s in ids:
            st = self.kv.spill_stats([s])
            if st["pool_traffic_frac"] > self.pdm:  # beyond PDM knee
                moved = self.kv.migrate_seq_to_local(s)
                if moved:
                    gb = moved * self.kv.cfg.page_bytes() / 2 ** 30
                    self.stats.migrations += 1
                    self.stats.migration_seconds += migration_seconds(gb)

        finished = []
        for i, s in enumerate(ids):
            req = self.batcher.active[s]
            req.generated += 1
            self._next_tokens[s] = int(nxt[i])
            self.outputs[s].append(int(nxt[i]))
            if req.done:
                finished.append(s)
        for s in finished:
            self.kv.release(s)
            self._next_tokens.pop(s, None)
        self.batcher.step_done(finished)
        return len(ids)

    def run(self, max_steps: int = 1000) -> EngineStats:
        for _ in range(max_steps):
            if not self.batcher.queue and not self.batcher.active:
                break
            self.step()
        return self.stats
