"""Data-parallel serving: independent engine replicas behind one dispatcher,
the port of ``dlti_tpu/serving/replicas.py``.

Each replica is a whole :class:`~dlti_tpu_torch.serving.engine.
InferenceEngine` (its own weights, KV pool, decode graphs, scheduler and
prefix cache) on its device; requests are dispatched least-loaded, or to a
sticky rendezvous-hash replica by affinity key. Replication sits above the
engine, not in it: independent engines prefill, decode and preempt on their
own schedules. One host thread drives them (:meth:`ReplicatedEngine.step`):
it launches every replica's decode round before it waits on any, so
replicas on different cards decode at once; a replica's only host syncs
are its engine's own.

* **Failover.** A replica whose step raises (a device fault, the engine's
  ``NumericFault``, the chaos hook) is taken out of dispatch and its
  requests resubmit on survivors, recomputed on readmission, up to
  ``max_retries`` each; past that, or with no survivor, a request finishes
  ``"error"``.
* **Live migration.** A planned drain (rolling reload, chaos ``preempt``)
  moves each decoding request to a survivor through the engine's paged-KV
  handoff (``export_handoff``/``adopt_handoff``), falling back to a
  resubmit when the handoff fails.
* **Self-healing** (``ReplicaLifecycleConfig.enabled``): a faulted replica
  is quarantined, rebuilt from a host copy of known-good weights after its
  probation, and reinstated only when a greedy canary matches the digest
  pinned at construction (``serving.lifecycle``).
* **Rolling reload** (:meth:`ReplicatedEngine.request_reload`): the new
  weights load on the caller's thread while the fleet serves; then one
  replica at a time is drained, rebuilt on them, canaried and reinstated,
  and the first one pins the new digest. No request errors, but each swap
  (re-verification, rebuild, canaries) runs on the stepper thread and
  stalls the survivors while it runs.

Every replica owns its weights, even on a shared device: its decode graph
reads them at fixed addresses, a NaN fault must poison one replica alone,
and a reload must swap one replica at a time. A rebuild frees the old
engine's device memory before it builds the new one.

Not ported (ROADMAP.md): replicas of tensor-parallel engines (the port's TP
engine is a multi-process world), the disaggregation pools' rescue hook,
the deploy controller's shadow tap and the flight recorder's fault dumps.

Each request keeps its ``trace_id`` through failover resubmits and live
migrations, and the wait from leaving a replica to re-admission on a
survivor books to its critical path as a ``failover`` or ``preempt`` stall
(``telemetry.ledger.note_requeue``), not as inflated prefill or decode.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import itertools
import logging
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from dlti_tpu_torch.config import LoRAConfig, ModelConfig, ReplicaLifecycleConfig
from dlti_tpu_torch.models.interop import jax_path
from dlti_tpu_torch.serving.engine import (
    EngineConfig, GenerationResult, InferenceEngine, Request,
)
from dlti_tpu_torch.serving.lifecycle import ReplicaLifecycle, canary_digest
from dlti_tpu_torch.serving.sampling import SamplingParams
from dlti_tpu_torch.telemetry.distributed_trace import mint_trace_id
from dlti_tpu_torch.telemetry.ledger import note_requeue
from dlti_tpu_torch.telemetry.lifecycle import RequestTelemetry
from dlti_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("dlti_tpu_torch.serving.replicas")

# Environment override of the chaos hook (GatewayConfig.fault_inject_step's
# "REPLICA:STEP[:MODE]"): kills a replica on a live server without a config
# edit.
FAULT_INJECT_ENV = "DLTI_GATEWAY_FAULT_INJECT"

_FAULT_MODES = ("raise", "nan-logits", "preempt")


def parse_fault_inject(spec: str) -> Optional[Tuple[int, int, str]]:
    """``"REPLICA:STEP[:MODE]"`` -> (replica, 1-based step count, mode), or
    None if unset. ``raise`` (default) raises :class:`ReplicaFault` in place
    of a device fault; ``nan-logits`` poisons the replica's weights with NaN
    so the engine's numeric guard trips; ``preempt`` drains the replica by
    live KV migration, then quarantines it."""
    spec = (spec or "").strip()
    if not spec:
        return None
    try:
        rep, _, rest = spec.partition(":")
        step, _, mode = rest.partition(":")
        mode = mode or "raise"
        if mode not in _FAULT_MODES:
            raise ValueError(mode)
        return int(rep), int(step), mode
    except ValueError:
        raise ValueError(f"fault_inject_step must be 'REPLICA:STEP[:MODE]' with MODE "
                         f"in {_FAULT_MODES}, got {spec!r}")


class ReplicaFault(RuntimeError):
    """Raised by the chaos hook in place of a real device fault."""


def fleet_devices(replicas: int, devices: Optional[Sequence] = None,
                  device=None) -> List[torch.device]:
    """The device of each replica: ``devices`` in order (a repeat puts two
    replicas on one device), else ``replicas`` times ``device``, else every
    visible CUDA device in order. Raises when there are fewer devices than
    replicas."""
    if devices is None:
        if device is not None:
            devices = [device] * replicas
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [resolve_device(None)]  # raises: no card, no device named
    devices = [resolve_device(d) for d in devices]
    if replicas > len(devices):
        raise ValueError(f"{replicas} replicas x tensor=1 needs {replicas} devices, "
                         f"have {len(devices)}")
    return devices[:replicas]


def _owned(params, device: torch.device) -> dict:
    """``params`` for an engine on ``device`` that shares no storage with
    the source: a leaf already there is copied; the engine's own placement
    copies the others as it moves them (one leaf at a time, so a host tree
    never lands on the card whole before an int8 engine quantizes it)."""
    return {k: v.detach().clone() if v.device == device else v for k, v in params.items()}


class ReplicatedEngine:
    """N independent engine replicas behind a least-loaded dispatcher, with
    :class:`InferenceEngine`'s surface (``submit``, ``step``, ``generate``,
    ``has_work``, ``stats``, ``slots``, ``waiting``, ``finished``,
    ``abort_all``).

    ``devices``: each replica's device (default: every visible CUDA device
    in order; ``device="cpu"`` puts every replica on the CPU).
    ``donate_params``: the first replica on the device ``params`` lie on
    takes them itself instead of a copy."""

    def __init__(self, model_cfg: ModelConfig, params, engine_cfg: EngineConfig = EngineConfig(),
                 lora_cfg: Optional[LoRAConfig] = None, *,
                 replicas: int = 1, tensor: int = 1,
                 devices: Optional[Sequence] = None, device=None,
                 max_retries: int = 2, fault_inject_step: str = "",
                 affinity_spill_threshold: int = 4,
                 lifecycle_cfg: Optional[ReplicaLifecycleConfig] = None,
                 donate_params: bool = False):
        if replicas < 1 or tensor < 1:
            raise ValueError(f"replicas ({replicas}) and tensor ({tensor}) must be >= 1")
        if tensor > 1:
            raise NotImplementedError(
                f"a fleet of tensor-parallel replicas (tensor={tensor}) is not ported yet "
                "(see ROADMAP.md): the port's TP engine is a multi-process world")
        self._devices = fleet_devices(replicas, devices, device)
        # One set of request histograms for the whole fleet.
        self.telemetry = RequestTelemetry()
        self._model_cfg = model_cfg
        self._lora_cfg = lora_cfg
        self._rep_cfgs: List[EngineConfig] = []
        for r in range(replicas):
            rep_cfg = engine_cfg
            if engine_cfg.prefix_disk_dir:
                # A disk tier a replica: one shared directory would let one
                # replica's eviction delete a block another's index names.
                rep_cfg = dataclasses.replace(engine_cfg, prefix_disk_dir=os.path.join(
                    engine_cfg.prefix_disk_dir, f"replica{r}"))
            self._rep_cfgs.append(rep_cfg)
        self.lifecycle_cfg = (lifecycle_cfg if lifecycle_cfg is not None
                              else ReplicaLifecycleConfig())
        self._heal = self.lifecycle_cfg.enabled
        # Known-good weights for quarantine rebuilds, a host copy (only kept
        # when healing is on); a completed rolling reload replaces it.
        self._weights_host = ({k: v.detach().to("cpu", copy=True) for k, v in params.items()}
                              if self._heal else None)
        # With donate_params the first replica on the tree's own device takes
        # the tree itself; every other gets its own copy.
        src = next(iter(params.values())).device if params else None
        donor = next((r for r, d in enumerate(self._devices) if d == src), None) \
            if donate_params else None
        self.engines: List[InferenceEngine] = []
        for r in range(replicas):
            rep_params = dict(params) if r == donor else _owned(params, self._devices[r])
            self.engines.append(self._build(r, rep_params))
            del rep_params
        del params
        self._rr = 0
        # The fleet's own id space: each engine's req-N counter starts at 0.
        self._req_counter = itertools.count()
        self.max_retries = max_retries
        self._dead: set = set()  # replicas out of dispatch and not stepped
        self._step_counts = [0] * replicas
        self._fault_inject = parse_fault_inject(
            os.environ.get(FAULT_INJECT_ENV) or fault_inject_step)
        # Failover counters (the gateway's dlti_gateway_* series read them).
        self.failover = {"retries": 0, "replica_faults": 0, "failover_errors": 0}
        # Cache-affinity routing: rendezvous hashing over the live replicas
        # (only the keys a dead replica owned re-rank), spilling
        # least-loaded when the sticky replica's backlog passes the
        # threshold.
        self.affinity_spill_threshold = affinity_spill_threshold
        self.affinity = {"sticky": 0, "spill": 0}
        self.lifecycle = ReplicaLifecycle(self.lifecycle_cfg, replicas)
        # Planned drains of a sole replica: no dispatch, but the engine keeps
        # stepping its in-flight work (unlike _dead, whose engines never step).
        self._draining: set = set()
        self._warmed = False
        self._reload: Optional[dict] = None
        self._reload_lock = threading.Lock()
        self._reload_loading = False  # a provider is running on its caller's thread
        # Outcome of the last rolling reload (None until one ran).
        self.last_reload_ok: Optional[bool] = None
        self._canary_digest: Optional[str] = None
        if self._heal:
            toks = self._run_canary(self.engines[0])
            if toks is not None:
                self._canary_digest = canary_digest(toks)
            else:
                logger.warning("lifecycle: canary digest could not be pinned at "
                               "construction; probes will gate on generation success only")

    def _build(self, idx: int, params: dict) -> InferenceEngine:
        """Replica ``idx``'s engine on its device from ``params``, a tree it
        may consume (each leaf is let go as it is placed)."""
        return InferenceEngine(self._model_cfg, params, self._rep_cfgs[idx], self._lora_cfg,
                               device=self._devices[idx], donate_params=True,
                               telemetry=self.telemetry)

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------
    def _load(self, eng: InferenceEngine) -> int:
        return len(eng.waiting) + eng.num_active

    def live_engines(self) -> List[InferenceEngine]:
        return [e for i, e in enumerate(self.engines)
                if i not in self._dead and i not in self._draining]

    @property
    def num_live(self) -> int:
        return len(self.engines) - len(self._dead | self._draining)

    def _sticky_target(self, key: str, live: List[InferenceEngine]) -> InferenceEngine:
        """Rendezvous (highest-random-weight) hashing: every live replica
        scores sha256(key:replica index) and the highest wins, so removing a
        replica re-ranks only the keys it owned."""
        def score(eng: InferenceEngine) -> bytes:
            return hashlib.sha256(f"{key}:{self.engines.index(eng)}".encode()).digest()

        return max(live, key=score)

    def new_request(self, prompt_token_ids: Sequence[int],
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None, adapter: str = "",
                    trace_id: str = "") -> Request:
        """A request for :meth:`dispatch`, checked as an engine's ``submit``
        checks it (``trace_id``: an upstream trace context, else a fresh
        one); touches no engine."""
        max_len = self.cfg.max_model_len
        if not prompt_token_ids:
            raise ValueError("prompt must contain at least one token")
        if len(prompt_token_ids) >= max_len:
            raise ValueError(f"prompt ({len(prompt_token_ids)} tokens) must be shorter "
                             f"than max_model_len={max_len}")
        return Request(request_id=request_id or f"rep-req-{next(self._req_counter)}",
                       prompt_token_ids=list(prompt_token_ids),
                       params=params or SamplingParams(), adapter=adapter,
                       trace_id=trace_id or mint_trace_id())

    def dispatch(self, req: Request, affinity_key: Optional[str] = None) -> Request:
        """Queue ``req`` on the least-loaded live replica (round-robin among
        ties), or with an ``affinity_key`` on its sticky rendezvous-hash
        replica unless that replica's backlog exceeds its decode slots by
        more than ``affinity_spill_threshold``. The adapter name rides the
        request, and each replica pins it in its own pool at admission."""
        live = self.live_engines()
        if not live:
            raise RuntimeError("all replicas dead (step faults); engine cannot accept requests")
        eng = None
        if affinity_key:
            sticky = self._sticky_target(affinity_key, live)
            if self._load(sticky) - sticky.cfg.max_seqs <= self.affinity_spill_threshold:
                eng = sticky
                self.affinity["sticky"] += 1
            else:
                self.affinity["spill"] += 1
        if eng is None:
            order = live[self._rr % len(live):] + live[:self._rr % len(live)]
            self._rr = (self._rr + 1) % len(live)
            eng = min(order, key=self._load)
        eng.enqueue(req)
        req.replica = self.engines.index(eng)
        return req

    def submit(self, prompt_token_ids: Sequence[int],
               params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               affinity_key: Optional[str] = None, adapter: str = "",
               trace_id: str = "") -> Request:
        """:meth:`new_request`, then :meth:`dispatch`. Not thread-safe against
        :meth:`step`: the server's ``AsyncEngine`` builds the request on the
        caller's thread and dispatches it on the stepper's."""
        return self.dispatch(self.new_request(prompt_token_ids, params, request_id, adapter,
                                              trace_id), affinity_key)

    @property
    def has_work(self) -> bool:
        return any(e.has_work for e in self.engines)

    # ------------------------------------------------------------------
    # Stepping and failover
    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One scheduler iteration on every live replica that has work, then
        one lifecycle action. Every replica's decode round is launched
        (:meth:`InferenceEngine.step_launch`) before any replica admits,
        prefills or waits on its round (:meth:`InferenceEngine.step_finish`),
        so replicas on different cards decode at once. A replica whose
        launch or completion raises is failed over (:meth:`_fail_replica`);
        the exception never escapes."""
        finished: List[Request] = []
        pending = {}
        for i, eng in enumerate(self.engines):
            if i in self._dead or not eng.has_work:
                continue
            try:
                self._step_counts[i] += 1
                fi = self._fault_inject
                if fi is not None and fi[0] == i and self._step_counts[i] == fi[1]:
                    if fi[2] == "nan-logits":
                        # This step's real forward emits NaN logits: the
                        # engine's guard, not this hook, must catch them.
                        self._poison_params_nan(eng, i)
                    elif fi[2] == "preempt":
                        logger.warning("chaos: preemption notice for replica %d at step %d",
                                       i, self._step_counts[i])
                        finished.extend(self.drain_replica(i))
                        continue
                    else:
                        raise ReplicaFault(f"gateway.fault_inject_step: injected fault on "
                                           f"replica {i} step {self._step_counts[i]}")
                pending[i] = eng.step_launch()
            except Exception as e:  # noqa: BLE001 - isolate a replica's fault
                finished.extend(self._fail_replica(i, e))
        for i, launched in pending.items():
            try:
                finished.extend(self.engines[i].step_finish(launched))
            except Exception as e:  # noqa: BLE001 - isolate a replica's fault
                finished.extend(self._fail_replica(i, e))
        self._lifecycle_tick()
        return finished

    @torch.no_grad()
    def _poison_params_nan(self, eng: InferenceEngine, idx: int) -> None:
        """nan-logits chaos: fill the replica's first floating-point weight
        (in the JAX tree's order) with NaN, in place, so its captured graph
        reads it too. The replica owns its weights, so no other sees it."""
        params = dict(eng.model.named_parameters())
        for name in sorted(params, key=jax_path):
            if params[name].is_floating_point():
                params[name].fill_(float("nan"))
                break
        logger.warning("chaos: poisoned replica %d params with NaN (nan-logits fault "
                       "injection)", idx)

    def _fail_replica(self, idx: int, exc: Exception) -> List[Request]:
        """Take replica ``idx`` out of dispatch and fail its requests over.
        Its device state is suspect, so nothing is salvaged: its slots are
        detached host-side (the pool goes with the engine) and each
        stranded request resubmits least-loaded on a survivor, which
        recomputes its prompt and tokens so far. A request past
        ``max_retries``, or with no survivor, finishes ``"error"``; those
        are returned."""
        self._dead.add(idx)
        self._draining.discard(idx)
        if self._heal:
            self.lifecycle.on_fault(idx)
        else:
            self.lifecycle.mark_dead(idx)
        self.failover["replica_faults"] += 1
        eng = self.engines[idx]
        logger.error("replica %d step failed (%s: %s); failing over %d in-flight + %d queued "
                     "request(s) to %d survivor(s)", idx, type(exc).__name__, exc,
                     eng.num_active, len(eng.waiting), self.num_live)
        stranded: List[Request] = []
        for slot in eng.slots:
            if slot.request is not None and not slot.request.done:
                stranded.append(slot.request)
            slot.request = None
            slot.blocks = []
            slot.seq_len = 0
            slot.next_pos = 0
            slot.prefill_end = 0
        stranded.extend(eng.waiting)
        eng.waiting.clear()
        survivors = self.live_engines()
        errored: List[Request] = []
        for req in stranded:
            errored.extend(self._rehome(req, eng, survivors, "failover"))
        return errored

    def _rehome(self, req: Request, eng: InferenceEngine,
                survivors: List[InferenceEngine], kind: str) -> List[Request]:
        """Resubmit one request on the least-loaded survivor (recomputed on
        readmission), its wait until then booked as a ``kind`` stall; or
        finish it ``"error"`` past the retry cap or with no survivor.
        Returns it if it errored."""
        if not survivors or req.num_retries >= self.max_retries:
            req.finish_reason = "error"
            req.finish_time = time.monotonic()
            self.failover["failover_errors"] += 1
            self.telemetry.on_finished(req)
            # In the finished ring, so the server's event drain delivers it.
            eng.finished.append(req)
            return [req]
        req.num_retries += 1
        self.failover["retries"] += 1
        note_requeue(req, kind)
        target = min(survivors, key=self._load)
        target.resubmit(req)
        req.replica = self.engines.index(target)
        return []

    # ------------------------------------------------------------------
    # Lifecycle: drain and migrate, rebuild, canary, reload
    # ------------------------------------------------------------------
    def drain_replica(self, idx: int, *, kind: str = "preempt",
                      quarantine: bool = True) -> List[Request]:
        """Planned drain of one replica: each decoding request moves to a
        survivor through the paged-KV handoff (tokens so far and the slot's
        seeded stream carry over; no re-prefill), falling back to a resubmit
        when the handoff fails; queued and mid-prefill requests resubmit.
        Each request's wait until a survivor takes it books as a ``kind``
        stall. With ``quarantine`` the replica then enters the lifecycle
        (quarantined with healing on, dead without); a rolling reload passes
        False and swaps the weights itself. Returns the requests that
        errored."""
        eng = self.engines[idx]
        self.lifecycle.begin_drain(idx)
        self._dead.add(idx)
        self._draining.discard(idx)
        survivors = self.live_engines()
        migrated = fallbacks = 0
        errored: List[Request] = []
        for slot in list(eng.slots):
            req = slot.request
            if req is None or req.done:
                continue
            # The survivor's adopt or admit closes the mark.
            note_requeue(req, kind)
            snap = None
            if survivors and not slot.prefilling:
                snap = eng.export_handoff(slot)
            if snap is not None:
                target = next((t for t in sorted(survivors, key=self._load)
                               if t.adopt_handoff(snap)), None)
                if target is not None:
                    req.num_migrations += 1
                    req.replica = self.engines.index(target)
                    migrated += 1
                    continue
                fallbacks += 1
            elif survivors and not slot.prefilling:
                fallbacks += 1
            # A failed export leaves the slot as it was: release it (the
            # drained engine is healthy, its blocks go back to its pool).
            if slot.request is not None:
                eng._release(slot)
            errored.extend(self._rehome(req, eng, survivors, kind))
        stranded = list(eng.waiting)
        eng.waiting.clear()
        for req in stranded:
            errored.extend(self._rehome(req, eng, survivors, kind))
        if migrated:
            self.lifecycle.note_migration(migrated)
        if fallbacks:
            self.lifecycle.note_migration_fallback(fallbacks)
        logger.warning("replica %d drained: %d decode(s) migrated via KV handoff, %d "
                       "re-prefill fallback(s), %d queued rehomed, %d errored", idx,
                       migrated, fallbacks, len(stranded), len(errored))
        if quarantine:
            if self._heal:
                self.lifecycle.on_fault(idx)
            else:
                self.lifecycle.mark_dead(idx)
        return errored

    def _rebuild_replica(self, idx: int, host_params=None) -> None:
        """A fresh engine for replica ``idx`` on its device from a host tree
        (the known-good snapshot by default). The old engine's device memory
        is freed first; its finished ring carries over, so the server still
        delivers what it holds."""
        host = host_params if host_params is not None else self._weights_host
        if host is None:
            raise RuntimeError("no weights snapshot to rebuild from (lifecycle healing "
                               "was disabled at construction)")
        old = self.engines[idx]
        old.executor.release()
        gc.collect()
        if self._devices[idx].type == "cuda":
            torch.cuda.empty_cache()
        eng = self._build(idx, _owned(host, self._devices[idx]))
        eng.finished.extend(old.finished)
        self.engines[idx] = eng
        if self._warmed:
            eng.warmup_decode_ladder()

    def _run_canary(self, eng: InferenceEngine) -> Optional[List[int]]:
        """A short greedy canary generation on an engine that carries no
        traffic (a rebuilt replica, or replica 0 at construction). Returns
        its token ids, or None when generation fails: a NaN-poisoned
        replica trips the engine's guard here, never in front of a
        client."""
        cfg = self.lifecycle_cfg
        vocab = max(2, self._model_cfg.vocab_size)
        prompt = [(i % min(97, vocab - 1)) + 1 for i in range(max(1, cfg.canary_prompt_tokens))]
        sp = SamplingParams(temperature=0.0, max_tokens=max(1, cfg.canary_max_tokens))
        try:
            req = eng.submit(prompt, sp, f"canary-{next(self._req_counter)}")
            for _ in range(1000):
                if req.done:
                    break
                eng.step()
            if not req.done or req.finish_reason == "error":
                return None
            return list(req.output_token_ids)
        except Exception as e:  # noqa: BLE001 - a failed canary is a verdict
            logger.warning("canary generation failed: %s", e)
            return None

    def _probe_replica(self, idx: int) -> None:
        """Probation elapsed: rebuild the quarantined replica from the
        known-good weights and reinstate it if its canary matches the pinned
        digest."""
        self.lifecycle.begin_probe(idx)
        toks = None
        try:
            self._rebuild_replica(idx)
            toks = self._run_canary(self.engines[idx])
        except Exception as e:  # noqa: BLE001 - a failed rebuild re-quarantines
            logger.error("replica %d rebuild/canary raised: %s", idx, e)
        ok = toks is not None and (self._canary_digest is None
                                   or canary_digest(toks) == self._canary_digest)
        if self.lifecycle.on_probe_result(idx, ok) == "live":
            self._dead.discard(idx)

    def request_reload(self, weights_provider: Callable[[], dict], *,
                       verify: Optional[Callable[[], bool]] = None) -> bool:
        """Start a rolling weight reload. ``weights_provider()`` runs here,
        on the caller's thread (the server's request thread) while the
        stepper serves on, and returns a host tree of the boot tree's names;
        the roll then runs on the stepper thread, a replica a lifecycle
        tick. ``verify()``, when given, runs before every replica's swap,
        and a False aborts the roll before that replica is touched. Returns
        False if a reload is already loading or rolling; a provider that
        raises fails the reload (``last_reload_ok`` False) and still
        returns True, as the reference's does at its first tick."""
        with self._reload_lock:
            if self._reload is not None or self._reload_loading:
                return False
            self._reload_loading = True
        try:
            host = weights_provider()
            # One attribute write hands the roll to the stepper.
            self._reload = {"host": host, "queue": None, "digest": None, "verify": verify}
        except Exception as e:  # noqa: BLE001 - a bad checkpoint fails the reload
            logger.error("rolling reload aborted: weights provider failed: %s", e)
            self.last_reload_ok = False
        finally:
            self._reload_loading = False
        return True

    def _reload_tick(self) -> None:
        """One rolling-reload action: drain one replica by migration, swap in
        the new weights, canary, reinstate. The first replica on the new
        weights pins the new digest after two identical canaries; a canary
        failure aborts the roll (the replica heals back onto the previous
        weights)."""
        st = self._reload
        if st["queue"] is None:
            st["queue"] = [i for i in range(len(self.engines))
                           if self.lifecycle.state(i) != "evicted"]
            logger.info("rolling reload: %d replica(s) queued", len(st["queue"]))
        if not st["queue"]:
            self._weights_host = st["host"]
            if st["digest"] is not None:
                self._canary_digest = st["digest"]
            self.last_reload_ok = True
            self._reload = None
            logger.info("rolling reload complete")
            return
        idx = st["queue"][0]
        if st["verify"] is not None:
            ok_verify = False
            try:
                ok_verify = bool(st["verify"]())
            except Exception as e:  # noqa: BLE001 - a verify fault fails it
                logger.error("reload re-verify raised: %s", e)
            if not ok_verify:
                logger.error("rolling reload aborted: export failed re-verification before "
                             "replica %d swap; fleet keeps serving (%d replica(s) already "
                             "on new weights stay)", idx,
                             len(self.engines) - len(st["queue"]))
                self.last_reload_ok = False
                self._reload = None
                return
        eng = self.engines[idx]
        others = [i for i in range(len(self.engines))
                  if i != idx and i not in self._dead and i not in self._draining]
        if others:
            self.drain_replica(idx, quarantine=False)
        else:
            # The sole live replica: nowhere to migrate. Stop its dispatch,
            # keep stepping it, and swap once its work is done.
            if idx not in self._draining and idx not in self._dead:
                self.lifecycle.begin_drain(idx)
                self._draining.add(idx)
            if eng.has_work:
                return
            self._draining.discard(idx)
            self._dead.add(idx)
        toks = None
        try:
            self._rebuild_replica(idx, host_params=st["host"])
            toks = self._run_canary(self.engines[idx])
        except Exception as e:  # noqa: BLE001 - a failed swap is handled below
            logger.error("replica %d reload rebuild failed: %s", idx, e)
        ok = toks is not None
        if ok and st["digest"] is None:
            ok = self._run_canary(self.engines[idx]) == toks
            if ok:
                st["digest"] = canary_digest(toks)
        elif ok:
            ok = canary_digest(toks) == st["digest"]
        st["queue"].pop(0)
        if self.lifecycle.on_probe_result(idx, ok) == "live":
            self._dead.discard(idx)
        if not ok:
            logger.error("rolling reload aborted: replica %d failed canary on new weights; "
                         "fleet stays on previous weights", idx)
            self.last_reload_ok = False
            self._reload = None

    def _lifecycle_tick(self) -> None:
        """At most one heavy lifecycle action a step: advance a rolling
        reload, else probe one quarantined replica whose probation
        elapsed."""
        if self._reload is not None:
            self._reload_tick()
            return
        if not self._heal:
            return
        due = self.lifecycle.due_probes()
        if due:
            self._probe_replica(due[0])

    @property
    def lifecycle_pending(self) -> bool:
        """True while the stepper must keep ticking without client work (a
        reload in flight, a quarantined replica awaiting its probe): the
        server's ``AsyncEngine`` polls instead of parking."""
        if self._reload is not None:
            return True
        if not self._heal:
            return False
        return any(s in ("quarantined", "probing") for s in self.lifecycle.states().values())

    def lifecycle_counts(self) -> dict:
        """``/health``'s summary: quarantined replicas heal and come back,
        dead ones (flap-evicted, or faulted with healing off) do not."""
        c = self.lifecycle.counts()
        return {"live": c["live"], "quarantined": c["quarantined"] + c["probing"],
                "draining": c["draining"], "dead": c["evicted"]}

    def generate(self, prompts: Sequence[Sequence[int]],
                 params: Optional[SamplingParams] = None) -> List[GenerationResult]:
        """Offline batch generation across every replica; a replica's fault
        fails over inside :meth:`step`."""
        reqs = [self.submit(p, params) for p in prompts]
        while self.has_work:
            self.step()
        return [self.engines[r.replica]._result(r) for r in reqs]

    # ------------------------------------------------------------------
    # The engine's surface (AsyncEngine, the gateway, the server)
    # ------------------------------------------------------------------
    def warmup_decode_ladder(self) -> None:
        self._warmed = True  # rebuilt replicas warm up before they go live
        for e in self.engines:
            e.warmup_decode_ladder()

    @property
    def cfg(self) -> EngineConfig:
        return self.engines[0].cfg

    @property
    def device(self) -> torch.device:
        """The first replica's device (the stepper thread's current card;
        every engine's calls select their own)."""
        return self._devices[0]

    @property
    def adapter_pool(self):
        return self.engines[0].adapter_pool

    @property
    def slots(self) -> list:
        return [s for e in self.engines for s in e.slots]

    @property
    def finished(self) -> List[Request]:
        return [r for e in self.engines for r in e.finished]

    @property
    def waiting(self) -> List[Request]:
        return [r for e in self.engines for r in e.waiting]

    @property
    def num_active(self) -> int:
        return sum(e.num_active for e in self.engines)

    @property
    def num_free_blocks(self) -> int:
        return sum(e.num_free_blocks for e in self.live_engines())

    def abort_all(self, reason: str = "abort") -> List[Request]:
        aborted: List[Request] = []
        for i, e in enumerate(self.engines):
            if i not in self._dead:
                aborted.extend(e.abort_all(reason=reason))
        return aborted

    @property
    def stats(self) -> dict:
        """Counters summed over the replicas (each replica's under
        ``replicas``)."""
        keys = self.engines[0].stats.keys()
        agg = {k: sum(e.stats[k] for e in self.engines) for k in keys}
        agg["replicas"] = [dict(e.stats) for e in self.engines]
        return agg
