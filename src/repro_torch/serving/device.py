"""Device-side SLM runtime (Synera §4.2-§4.4); port of
``repro/serving/device.py``.

Runs the on-device SLM with:
  * per-step confidence + importance extraction (naive attention path or
    the fused attn_importance kernel, ``attn_impl="pallas"``),
  * layer-wise early exit (margin over the last 25% of layers) — all
    layers execute and the exit *decision* feeds the latency/energy
    model,
  * draft chunking (gamma tokens) + selective offload decisions,
  * compression of the transmitted distributions,
  * stall-free parallel inference (rejection-position prediction + PI).

The generation loop is a resumable coroutine (``generate_steps``) that
yields ``CloudCall`` requests and is resumed with ``CloudReply``
responses, so a ``SyneraServer`` can interleave many concurrent streams
over one cloud engine; ``generate`` is the blocking single-stream
loop over it.

Position bookkeeping invariant: ``seq`` is the accepted token stream
(prompt + output).  At the top of every loop iteration, positions
0..len(seq)-2 are in the device cache and ``seq[-1]`` is not yet fed.
Drafting feeds ``seq[-1]`` at position len(seq)-1 and autoregressively
produces gamma draft tokens.  After a rejection, stale draft KV beyond
the accepted frontier is masked by causality until overwritten (the same
argument as the cloud scheduler's).

The SLM must be a dense decoder (the paper's SLMs are Llama-family).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import compression as CP
from repro_torch.core import early_exit as EE
from repro_torch.core import parallel as PI
from repro_torch.core.offload import OffloadPolicy
from repro_torch.core.profiling import ChunkRecord
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.runtime import resolve_device
from repro_torch.serving.link import DeviceLatencyModel, LinkModel
from repro_torch.serving.trace import StreamTimeline as Timeline


@dataclass
class CloudCall:
    """A cloud request emitted by the device generation coroutine.

    ``send_ms`` is the *device-stream-relative* time the payload leaves
    the device; the serving layer maps it onto the shared absolute clock
    (``session.start_ms + send_ms``).  ``arrival_ms`` (still stream
    relative) adds the uplink transfer.
    """
    kind: str                     # "prefill" | "verify"
    send_ms: float
    uplink_ms: float
    prompt: list | None = None    # prefill
    seq: list | None = None       # verify: accepted stream (prompt+output)
    draft: list | None = None     # verify: pending draft tokens
    dists: list | None = None     # verify: compressed SLM dists

    @property
    def arrival_ms(self) -> float:
        return self.send_ms + self.uplink_ms


@dataclass
class CloudReply:
    """Response delivered back into the coroutine for a verify call.

    ``cloud_ms`` is time spent at the cloud from request arrival to
    completion — queueing behind other streams *plus* compute, as
    measured on the shared clock.
    """
    result: object = None         # VerifyResult
    cloud_ms: float = 0.0
    fed_tokens: int = 0           # tokens this request fed the cloud LLM
    # chronological (category, ms) decomposition of the request's
    # in-flight window at the cloud (Tracer.window_parts); None when
    # tracing is off — the stall then lands in the "other" bucket
    cloud_parts: list | None = None


@dataclass
class DeviceMetrics:
    tokens: list = field(default_factory=list)
    n_chunks: int = 0
    n_offloaded: int = 0
    n_draft_tokens: int = 0
    n_accepted_tokens: int = 0
    n_cloud_tokens: int = 0        # tokens emitted via cloud verification
    n_cloud_fed_tokens: int = 0    # tokens forwarded through the cloud LLM
    n_local_tokens: int = 0
    pi_position_hits: int = 0
    pi_adopted: int = 0
    pi_attempts: int = 0
    layers_saved_frac: list = field(default_factory=list)
    uplink_bytes: int = 0
    downlink_bytes: int = 0
    chunk_records: list = field(default_factory=list)
    timeline: Timeline = field(default_factory=Timeline)

    @property
    def offload_rate(self) -> float:
        return self.n_offloaded / max(self.n_chunks, 1)

    @property
    def acceptance_rate(self) -> float:
        return self.n_accepted_tokens / max(self.n_draft_tokens, 1)

    @property
    def tbt_ms(self) -> float:
        return self.timeline.t_ms / max(len(self.tokens), 1)

    @property
    def cloud_token_frac(self) -> float:
        return self.n_cloud_tokens / max(len(self.tokens), 1)

    @property
    def mean_layers_saved(self) -> float:
        return float(np.mean(self.layers_saved_frac)) if self.layers_saved_frac else 0.0


def _make_device_step(cfg):
    """Single-token step returning per-layer last-position logits (for
    early exit) in the model's dtype, mean importance over the cache, and
    the cache (updated in place)."""

    def step(params, cache, token, pos):
        h = params["embed"][token]                    # (1, 1, d)
        windex = L.cache_write_index(pos, cache["layers"]["k"].shape[2])
        imps, h_layers = [], []
        for i in range(cfg.n_layers):
            h, _, imp, _ = M._layer(cfg, M.layer_slice(params["layers"], i),
                                    h, pos, M.layer_slice(cache["layers"], i),
                                    ret_imp=True, write_index=windex)
            imps.append(imp)
            h_layers.append(h[:, -1])
        hl = L.rms_norm(torch.stack(h_layers), params["final_norm"],
                        cfg.norm_eps)                 # (L, 1, d)
        unemb = (params["embed"].T if cfg.tie_embeddings
                 else params["unembed"])
        layer_logits = (hl @ unemb)[:, 0]             # (L, V)
        imp_mean = torch.stack(imps).mean(0)[0]       # (S,) over cache slots
        return layer_logits, imp_mean, cache

    return step


def _clone_cache(cache):
    """A private copy of a dense cache.  The reference's caches are
    immutable, so its parallel-inference speculation drafts into a new
    cache and a non-adopted speculation leaves the old one untouched; the
    port updates in place and so speculates on a copy."""
    return {"layers": {k: v.clone() for k, v in cache["layers"].items()}}


class DeviceRuntime:
    def __init__(self, cfg, params, *, s_max: int = 512, gamma: int = 4,
                 policy: OffloadPolicy | None = None,
                 ee: EE.EarlyExitConfig | None = None,
                 sampling: str = "greedy", comp_top_k: int = 8,
                 latency: DeviceLatencyModel | None = None,
                 link: LinkModel | None = None, seed: int = 0,
                 use_early_exit: bool = True, use_pi: bool = True,
                 use_compression: bool = True, alpha: float = 0.7,
                 wire_vocab: int = 0, device=None):
        assert cfg.family == "dense", "device SLM must be a dense decoder"
        self.device = resolve_device(device)
        # importance extraction needs the attention matrix (naive) or the
        # fused attn_importance Pallas kernel; anything else maps to naive
        impl = "pallas" if cfg.attn_impl == "pallas" else "naive"
        # the device cache is a single short dense buffer (batch=1); paging
        # is a cloud-engine concern — force the dense layout here so the
        # importance slot math (pos % s_max) stays valid
        self.cfg = cfg.replace(attn_impl=impl, remat=False,
                               cache_impl="dense")
        self.params = params
        self.s_max = s_max
        self.gamma = gamma
        self.policy = policy or OffloadPolicy()
        self.ee = ee or EE.EarlyExitConfig()
        self.sampling = sampling
        self.comp_top_k = comp_top_k
        self.latency = latency or DeviceLatencyModel()
        self.link = link or LinkModel()
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.use_early_exit = use_early_exit
        self.use_pi = use_pi
        self.use_compression = use_compression
        self.alpha = alpha
        # Payload accounting vocab: the experiments use a tiny task vocab,
        # but the WAN transfer sizes of the paper (Fig 13) are set by a
        # production vocab (32,000 for Llama-2).  ``wire_vocab`` sizes the
        # *uncompressed* distribution payload accordingly; the compressed
        # payload only depends on the sampling support (top-k), so this
        # affects exactly what it should.
        self.wire_vocab = wire_vocab or self.cfg.vocab

        self._step = _make_device_step(self.cfg)
        self._prefill = (
            lambda p, c, t, pos: M.forward(self.cfg, p, t, pos, cache=c)[:2])

    # ------------------------------------------------------------------
    def _sample(self, logits: np.ndarray) -> int:
        if self.sampling == "greedy":
            return int(np.argmax(logits))
        c = CP.compress(logits, method="top_k", k=self.comp_top_k)
        p = c.val.astype(np.float64)
        return int(self.rng.choice(c.idx, p=p / p.sum()))

    def _one_token(self, cache, token: int, pos: int, m: DeviceMetrics):
        """Feed `token` at `pos`; returns (logits, conf, imp_vec, cache)."""
        tk = torch.tensor([[token]], dtype=torch.long, device=self.device)
        ps = torch.tensor([[pos]], dtype=torch.int32, device=self.device)
        layer_logits, imp_vec, cache = self._step(self.params, cache, tk, ps)
        # per-layer logits leave the device in the model's dtype and
        # become f32 on the host, as in the reference
        layer_logits = layer_logits.float().cpu().numpy()  # (L, V)
        nL = layer_logits.shape[0]
        if self.use_early_exit:
            exit_layer, _, _ = EE.pick_exit_layer(
                layer_logits[:, None, :], nL, self.ee)
            el = int(exit_layer[0])
            logits = layer_logits[el]
            frac_saved = (nL - 1 - el) / nL
        else:
            logits = layer_logits[-1]
            frac_saved = 0.0
        m.layers_saved_frac.append(frac_saved)
        m.timeline.advance(self.latency.draft_ms(1, 1.0 - frac_saved),
                           "compute")
        m.timeline.energy_j += self.latency.energy_j(1, 1.0 - frac_saved)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        conf = float(probs.max())
        return logits, conf, imp_vec.float().cpu().numpy(), cache

    def _draft_chunk(self, cache, first_token: int, start_pos: int,
                     m: DeviceMetrics):
        """Feed `first_token` at `start_pos` and draft gamma tokens.

        Draft token d_j (1-indexed) gets fed at position start_pos + j;
        its importance accumulates the attention later in-chunk queries
        (including itself) pay to its key.
        Returns (tokens [d_1..d_g], logits_list, confs, imp (g,), cache).
        """
        tokens, logits_list, confs = [], [], []
        imp_acc = np.zeros(self.gamma, np.float64)
        tok, pos = first_token, start_pos
        for j in range(self.gamma):
            logits, conf, imp_vec, cache = self._one_token(cache, tok, pos, m)
            nxt = self._sample(logits)
            tokens.append(nxt)
            logits_list.append(logits)
            confs.append(conf)
            for jj in range(1, j + 1):   # keys of d_1..d_j are in cache
                slot = (start_pos + jj) % self.s_max
                imp_acc[jj - 1] += float(imp_vec[slot])
            tok, pos = nxt, pos + 1
        return tokens, logits_list, confs, imp_acc / self.gamma, cache

    # ------------------------------------------------------------------
    def generate(self, prompt: list[int], max_new: int, cloud=None,
                 profile_mode: bool = False) -> DeviceMetrics:
        """Generate up to ``max_new`` tokens after the prompt (blocking).

        ``cloud`` implements the CloudClient protocol (serving/synergy.py)
        or None for edge-centric generation.  profile_mode offloads every
        chunk and records ChunkRecords for offline profiling (§5).

        This is a thin synchronous loop over :meth:`generate_steps`;
        multi-tenant serving drives the coroutine directly through
        ``SyneraServer`` so device compute from many streams interleaves
        with shared cloud iterations.
        """
        gen = self.generate_steps(prompt, max_new,
                                  use_cloud=cloud is not None,
                                  profile_mode=profile_mode)
        reply = None
        while True:
            try:
                call = gen.send(reply)
            except StopIteration as e:
                return e.value
            if call.kind == "prefill":
                cloud.prefill(call.prompt, arrival_ms=call.arrival_ms)
                reply = None
            else:
                result, cloud_ms = cloud.verify(
                    seq=call.seq, draft=call.draft, dists=call.dists,
                    arrival_ms=call.arrival_ms)
                reply = CloudReply(result=result, cloud_ms=cloud_ms,
                                   fed_tokens=cloud.last_fed_tokens)

    def generate_steps(self, prompt: list[int], max_new: int, *,
                       use_cloud: bool = True, profile_mode: bool = False,
                       emit=None, trace=None):
        """Device generation as a resumable coroutine.

        Yields a :class:`CloudCall` whenever the stream needs the cloud;
        the caller resumes it with ``None`` for fire-and-forget prefill
        notifications and with a :class:`CloudReply` carrying the
        ``VerifyResult`` for verify calls.  Returns (via StopIteration)
        the stream's :class:`DeviceMetrics`.

        ``emit(tokens, t_ms)`` is the incremental-output hook (token
        streaming): it fires each time accepted output tokens are
        appended to the stream — a locally kept draft chunk or the
        verified tokens of a cloud round trip — with the new tokens
        (clipped to ``max_new``) and the stream-relative device time.
        ``seq`` only ever grows (rejected drafts never enter it), so
        emitted tokens are final: their concatenation is byte-identical
        to the returned ``DeviceMetrics.tokens``.

        ``trace(name, t0_ms, t1_ms)`` is the optional tracing hook
        (serving/trace.py): it receives stream-relative device-side
        spans — ``draft`` (SLM compute), ``pi_overlap`` (speculation
        masking a round trip), ``stall`` (unmasked round-trip tail).
        Tracing is passive; timings and tokens are identical with it on
        or off.

        All device-side state (KV cache, accepted stream, timeline) lives
        in this generator's frame, so one ``DeviceRuntime`` (weights +
        steps) can back arbitrarily many concurrent sessions.
        """
        m = DeviceMetrics()
        cache = M.init_cache(self.cfg, 1, self.s_max, device=self.device)
        prompt = [int(t) for t in prompt]
        T = len(prompt)
        assert T >= 2, "need at least 2 prompt tokens"
        max_len = max_new
        # dedicated offload-decision stream, deterministic per prompt:
        # ablation variants (PI on/off, EE on/off) then share identical
        # offload decisions, so quality differences isolate the mechanism
        # under test (PI is exactness-preserving; only latency may move)
        rng_off = np.random.default_rng(
            self.seed * 1000003 + sum(prompt) + 31 * T)

        # Feed prompt[:-1] so the invariant holds with seq = prompt: the
        # first generated token is itself a draft token (SLM-centric
        # generation; *every* output token is subject to verification).
        tk = torch.tensor([prompt[:-1]], dtype=torch.long, device=self.device)
        pos = torch.arange(T - 1, dtype=torch.int32, device=self.device)[None]
        _, cache = self._prefill(self.params, cache, tk, pos)
        m.timeline.advance(self.latency.draft_ms(T - 1, 1.0), "compute")
        m.timeline.energy_j += self.latency.energy_j(T - 1, 1.0)
        t_mark = m.timeline.t_ms   # device time already emitted as spans
        if trace is not None:
            trace("prompt_feed", 0.0, t_mark)

        if use_cloud:
            up = 4 * T + 32
            m.uplink_bytes += up
            dt = self.link.transfer_ms(up)
            # fire-and-forget: cloud prefill overlaps device drafting; the
            # scheduler serializes it before this stream's first verify
            yield CloudCall("prefill", send_ms=m.timeline.t_ms,
                            uplink_ms=dt, prompt=prompt)

        seq = list(prompt)     # invariant: seq[:-1] fed, seq[-1] not fed
        pi_chunk = None
        n_emitted = 0

        def _flush_emit():
            nonlocal n_emitted
            if emit is None:
                return
            vis = min(len(seq) - T, max_new)
            if vis > n_emitted:
                emit(seq[T + n_emitted:T + vis], m.timeline.t_ms)
                n_emitted = vis

        while len(seq) - T < max_new:
            if pi_chunk is not None:
                tokens, logits_list, confs, imp, cache = pi_chunk
                pi_chunk = None
            else:
                tokens, logits_list, confs, imp, cache = self._draft_chunk(
                    cache, seq[-1], len(seq) - 1, m)
            m.n_chunks += 1
            mean_conf = float(np.mean(confs))
            mean_imp = float(np.mean(imp))

            do_offload = use_cloud
            if do_offload and not profile_mode:
                do_offload = self.policy.should_offload(
                    rng_off, mean_conf, mean_imp,
                    seq_pos=len(seq) - T, max_len=max_len,
                    seq_exit_frac=(self.ee.seq_exit_frac
                                   if self.use_early_exit else 0.0),
                    chunk_index=m.n_chunks - 1)

            if not do_offload:
                seq.extend(tokens)
                m.n_local_tokens += len(tokens)
                _flush_emit()
                continue

            # ---- offload: build + send the verification request --------
            m.n_offloaded += 1
            m.n_draft_tokens += len(tokens)  # drafts actually verified
            dists = [CP.compress(
                lg, method=("greedy" if self.sampling == "greedy"
                            else "top_k"), k=self.comp_top_k)
                for lg in logits_list]
            payload = CP.chunk_payload_bytes(
                dists, len(tokens), compressed=self.use_compression,
                vocab=self.wire_vocab)
            m.uplink_bytes += payload
            uplink_ms = self.link.transfer_ms(payload)

            # ---- stall-free parallel inference (during the round trip) --
            # Position note: before this chunk len(seq) = n; drafting fed
            # seq[-1]@n-1 and d_1..d_{gamma-1}@n..n+gamma-2.  d_gamma
            # (position n+gamma-1) is NOT yet in the cache.
            draft_base = len(seq)          # d_j sits at draft_base + j - 1
            pi_state = None
            dgamma_fed = False
            overlap_t0 = m.timeline.t_ms
            if self.use_pi and not profile_mode:
                m.pi_attempts += 1
                r_star = PI.predict_rejection(np.asarray(confs), self.alpha,
                                              self.rng)
                if r_star < self.gamma:
                    c3 = CP.compress(logits_list[r_star], method="top_k", k=3)
                    alt = PI.choose_alternative(c3.idx, c3.val,
                                                tokens[r_star], self.rng)
                    # d_1..d_{r*} already fed; alt replaces d_{r*+1}.
                    # Speculate on a copy: the cache is updated in place,
                    # and a rejected speculation must leave the accepted
                    # prefix's KV as drafting wrote it
                    spec = self._draft_chunk(_clone_cache(cache), alt,
                                             draft_base + r_star, m)
                else:
                    # predicted full acceptance: SLM predicts the bonus
                    logits_b, _, _, cache = self._one_token(
                        cache, tokens[-1], draft_base + self.gamma - 1, m)
                    dgamma_fed = True
                    alt = self._sample(logits_b)
                    spec = self._draft_chunk(_clone_cache(cache), alt,
                                             draft_base + self.gamma, m)
                pi_state = PI.PIState(r_star=r_star, alt_token=alt,
                                      tokens=spec)
            overlap_ms = m.timeline.t_ms - overlap_t0
            if trace is not None:
                if overlap_t0 > t_mark:
                    trace("draft", t_mark, overlap_t0)
                if overlap_ms > 0.0:
                    trace("pi_overlap", overlap_t0, m.timeline.t_ms)

            # ---- cloud round trip ---------------------------------------
            reply = yield CloudCall("verify", send_ms=overlap_t0,
                                    uplink_ms=uplink_ms,
                                    seq=list(seq), draft=list(tokens),
                                    dists=dists)
            result, cloud_ms = reply.result, reply.cloud_ms
            m.n_cloud_fed_tokens += reply.fed_tokens
            down_bytes = 32 + 4 * (len(result.tokens) + 1)
            m.downlink_bytes += down_bytes
            down_ms = self.link.transfer_ms(down_bytes)
            rtt_ms = uplink_ms + cloud_ms + down_ms

            # PI compute overlapped with the round trip; only the excess
            # round-trip time stalls the pipeline (Fig 6).
            stall_ms = max(rtt_ms - overlap_ms, 0.0)
            if trace is not None and stall_ms > 0.0:
                trace("stall", m.timeline.t_ms, m.timeline.t_ms + stall_ms)
            m.timeline.advance_stall(stall_ms, uplink_ms, reply.cloud_parts,
                                     down_ms, overlap_ms)
            m.timeline.comm_ms += min(rtt_ms, overlap_ms)  # masked comm
            t_mark = m.timeline.t_ms

            n_acc = result.n_accepted
            verified = list(result.tokens)  # accepted prefix + corrected/bonus
            seq.extend(verified)
            m.n_cloud_tokens += len(verified)
            m.n_accepted_tokens += n_acc
            _flush_emit()

            if n_acc >= self.gamma and not dgamma_fed:
                # full acceptance: d_gamma entered `seq` but was never fed
                # during drafting — feed it so the cache covers seq[:-1]
                _, _, _, cache = self._one_token(
                    cache, tokens[-1], draft_base + self.gamma - 1, m)

            if profile_mode:
                m.chunk_records.append(ChunkRecord(
                    mean_conf=mean_conf, mean_imp=mean_imp,
                    n_accepted=n_acc, gamma=self.gamma))

            if pi_state is not None:
                adopt, pos_hit = PI.merge(pi_state, n_acc, verified[-1],
                                          self.gamma)
                m.pi_position_hits += int(pos_hit)
                m.pi_adopted += int(adopt)
                if adopt:
                    # the speculative chunk is the next draft chunk; the
                    # cache already covers seq[-1]
                    pi_chunk = pi_state.tokens
            # on non-adoption, stale speculative KV beyond len(seq)-1 is
            # causally masked until overwritten — nothing to roll back.

        m.tokens = seq[T:T + max_new]
        _flush_emit()
        if trace is not None and m.timeline.t_ms > t_mark:
            trace("draft", t_mark, m.timeline.t_ms)
        return m

    # ------------------------------------------------------------------
    def perplexity(self, tokens: list[int]) -> float:
        """Prompt perplexity under the SLM (EdgeFM-LLM baseline input-level
        offload signal)."""
        tk = torch.tensor([tokens], dtype=torch.long, device=self.device)
        pos = M.default_positions(1, len(tokens), device=self.device)
        logits, _, _, _ = M.forward(self.cfg, self.params, tk, pos)
        logp = torch.log_softmax(logits[:, :-1].float(), -1)
        nll = -torch.gather(logp, -1, tk[:, 1:, None]).mean()
        return float(torch.exp(nll))
