"""Persistent per-machine profile store: traced runs become planner
feedback that survives the process.

Every traced ladder/benchmark run deposits (predicted, measured,
bottleneck) samples keyed by ``(machine fingerprint, target name, plan
signature)``.  ``explore_chain(profile=...)`` later asks the store for a
:class:`~repro_torch.memory.dse.CostCorrection` refit from this machine's
samples -- exact plan signature first, target-wide fallback -- so DSE
ranking starts from learned per-term factors instead of cold.

The store is one JSON file, ``~/.cache/repro_torch/profile.json`` by
default, overridable with the ``REPRO_TORCH_PROFILE`` environment variable
(point it at a scratch path in tests/CI).  Writes are atomic (tmp + rename) and the
per-key sample history is FIFO-bounded, so concurrent benchmark runs
cannot corrupt it or grow it without bound.

Staleness is bounded by a *code epoch*, not just the FIFO: every sample
is stamped with :func:`cost_model_epoch` (the planner's
``COST_MODEL_VERSION``) at record time, queries and ``correction()``
refits only see current-epoch samples, and recording prunes the rest --
so bumping the cost model orphans all pre-bump feedback instead of
letting it steer the new model.  Store files written before epochs
existed load fine; their unstamped samples are simply ignored.

The epoch is a declared version, and planner edits rarely remember to
bump it -- so samples are *also* stamped with :func:`plan_code_digest`,
a digest of the planner's own source (``memory.chain`` / ``memory.dse``
/ ``memory.pipeline``).  When the plan *code* changes under an
unchanged ``COST_MODEL_VERSION``, queries stop surfacing the old
samples and recording prunes them.  Samples without a ``src`` stamp
(older store files) are tolerated: the digest gates code drift, it does
not orphan history that predates the stamp.
"""
from __future__ import annotations

import copy
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Union

from .attribution import samples_from_trace
from .tracer import Tracer

#: Environment variable overriding the store path.
PROFILE_ENV = "REPRO_TORCH_PROFILE"
#: Samples kept per (fingerprint, target, signature) key (FIFO).
MAX_SAMPLES_PER_KEY = 200
_VERSION = 1


def cost_model_epoch() -> str:
    """The epoch tag stamped on recorded samples: the planner's
    ``COST_MODEL_VERSION``.  A sample only means "the model was off by
    r on this machine" for the model that predicted it."""
    try:
        from ..memory.dse import COST_MODEL_VERSION  # lazy: no cycle
    except Exception:  # pragma: no cover - partial installs
        return "v0"
    return f"v{COST_MODEL_VERSION}"


_PLAN_CODE_DIGEST: Optional[str] = None


def plan_code_digest() -> str:
    """Digest of the planner's own source code (``memory.chain``,
    ``memory.dse``, ``memory.pipeline``), cached per process.  A sample
    calibrates the model *as coded*: when the planner changes without a
    ``COST_MODEL_VERSION`` bump, this digest changes and the old
    feedback ages out anyway."""
    global _PLAN_CODE_DIGEST
    if _PLAN_CODE_DIGEST is None:
        import hashlib
        import inspect

        try:
            from ..memory import chain, dse, pipeline  # lazy: no cycle

            blob = "\n".join(
                inspect.getsource(m) for m in (chain, dse, pipeline)
            )
            _PLAN_CODE_DIGEST = hashlib.sha1(
                blob.encode()
            ).hexdigest()[:12]
        except Exception:  # pragma: no cover - partial installs
            _PLAN_CODE_DIGEST = "src0"
    return _PLAN_CODE_DIGEST


def default_profile_path() -> str:
    env = os.environ.get(PROFILE_ENV)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "profile.json"
    )


def machine_fingerprint(device=None) -> str:
    """Short stable id of *this* machine + runtime: learned factors are
    only valid where they were measured.

    Built from the host (``platform``), the device measured on -- the
    CUDA card's name and the card count, or ``cpu`` -- and the CUDA
    version torch was built for.  ``device`` is the device the samples
    come from: ``None`` is the CUDA card where there is one, else the
    host; ``"cpu"`` is always the host, so samples measured on the host
    never share a key with samples measured on a card."""
    import hashlib
    import platform

    import torch

    parts = [
        platform.system(), platform.machine(), platform.node(),
        str(os.cpu_count() or 0),
    ]
    dev = (torch.device(device) if device is not None
           else torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        parts += ["cuda", torch.cuda.get_device_name(dev),
                  str(torch.cuda.device_count())]
    else:
        parts.append("cpu")
    parts.append(str(torch.version.cuda))
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


class ProfileStore:
    """On-disk (predicted, measured) sample archive + correction refit.

    Samples are dicts with at least ``predicted_s``, ``measured_s`` and
    ``bottleneck`` (a ``CostBreakdown.bottleneck`` label); ``scope``
    says what was measured (``chain``, ``stage:<name>``, ``bench:<rung>``).
    """

    def __init__(self, path: Optional[str] = None,
                 fingerprint: Optional[str] = None,
                 epoch: Optional[str] = None,
                 src: Optional[str] = None):
        self.path = path or default_profile_path()
        #: an explicit fingerprint is kept by :meth:`for_device`
        self._pinned = fingerprint is not None
        self.fingerprint = fingerprint or machine_fingerprint()
        #: samples are stamped with this at record time and only
        #: same-epoch samples feed queries/refits (tests override it to
        #: simulate a cost-model bump)
        self.epoch = epoch or cost_model_epoch()
        #: the planner-source digest stamped alongside the epoch;
        #: samples carrying a *different* digest are stale even when the
        #: declared epoch never moved (tests override it to simulate a
        #: silent planner edit)
        self.src = src or plan_code_digest()
        self.data: Dict[str, Any] = {"version": _VERSION, "entries": {}}
        self._load()

    @classmethod
    def open(cls, profile: Union["ProfileStore", str, bool, None]
             ) -> Optional["ProfileStore"]:
        """Normalize ``explore_chain(profile=...)``'s argument: a store,
        a path, or ``True`` for the default location."""
        if profile is None or profile is False:
            return None
        if isinstance(profile, ProfileStore):
            return profile
        if profile is True:
            return cls()
        return cls(path=str(profile))

    def for_device(self, device) -> "ProfileStore":
        """This store keyed for samples measured on ``device``: itself
        when its fingerprint is that device's (or was given explicitly),
        else a view on the same file and data with that device's
        :func:`machine_fingerprint`, so a run on the host never feeds or
        reads a card's samples."""
        fp = machine_fingerprint(device)
        if self._pinned or fp == self.fingerprint:
            return self
        view = copy.copy(self)
        view.fingerprint = fp
        return view

    # -- persistence --------------------------------------------------------
    def _load(self) -> None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        if isinstance(doc, dict) and isinstance(doc.get("entries"), dict):
            self.data = {"version": _VERSION, "entries": doc["entries"]}

    def save(self) -> None:
        """Atomic write: a crashed benchmark never leaves a torn file."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.data, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- recording ----------------------------------------------------------
    def _key(self, target_name: str, signature: str) -> str:
        return f"{self.fingerprint}/{target_name}/{signature}"

    def record(self, target_name: str, signature: str,
               samples: List[Dict[str, Any]], *, save: bool = True) -> int:
        """Append samples under (this machine, target, signature),
        stamped with the current code epoch and planner-source digest;
        FIFO-bounded.  Samples already in the bucket that carry a stale
        epoch or a mismatched source digest are pruned on the way (the
        file shrinks back as post-change feedback arrives).  Returns how
        many were accepted."""
        good = [
            dict(s, epoch=self.epoch, src=self.src) for s in samples
            if isinstance(s.get("predicted_s"), (int, float))
            and isinstance(s.get("measured_s"), (int, float))
            and s["predicted_s"] > 0 and s["measured_s"] > 0
        ]
        if not good:
            return 0
        entries = self.data["entries"]
        key = self._key(target_name, signature)
        bucket = [
            s for s in entries.get(key, ())
            if isinstance(s, dict) and s.get("epoch") == self.epoch
            and s.get("src", self.src) == self.src
        ]
        entries[key] = bucket
        bucket.extend(good)
        del bucket[:-MAX_SAMPLES_PER_KEY]
        if save:
            self.save()
        return len(good)

    def record_trace(self, tracer: Tracer, plan, *,
                     save: bool = True) -> int:
        """Refit fodder from one traced chain run: per-stage and chain-
        level (predicted, measured) pairs via ``attribution``."""
        return self.record(
            plan.target.name, plan.signature,
            samples_from_trace(tracer, plan), save=save,
        )

    def record_measurement(self, plan, predicted_s: float,
                           measured_s: float, *, scope: str = "bench",
                           save: bool = True) -> int:
        """One measured run without a trace (the benchmark ladders)."""
        return self.record(
            plan.target.name, plan.signature,
            [{
                "scope": scope,
                "predicted_s": float(predicted_s),
                "measured_s": float(measured_s),
                "bottleneck": plan.cost.bottleneck,
            }],
            save=save,
        )

    # -- queries ------------------------------------------------------------
    def samples(self, target_name: str,
                signature: Optional[str] = None) -> List[Dict[str, Any]]:
        """This machine's *current-epoch* samples for a target: exact
        signature when it has history, otherwise everything recorded for
        the target (a new plan still benefits from the machine's overall
        bias).  Samples stamped with another epoch -- or none, from a
        store file predating epochs -- never surface, and neither do
        samples whose planner-source digest no longer matches the code
        that is running: the correction refit must not be steered by an
        obsolete cost model."""

        def live(v) -> List[Dict[str, Any]]:
            return [
                s for s in v
                if isinstance(s, dict) and s.get("epoch") == self.epoch
                and s.get("src", self.src) == self.src
            ]

        entries = self.data["entries"]
        if signature is not None:
            exact = live(entries.get(self._key(target_name, signature), ()))
            if exact:
                return exact
        prefix = f"{self.fingerprint}/{target_name}/"
        out: List[Dict[str, Any]] = []
        for k, v in sorted(entries.items()):
            if k.startswith(prefix) and isinstance(v, list):
                out.extend(live(v))
        return out

    def correction(self, target_name: str,
                   signature: Optional[str] = None):
        """Refit a :class:`~repro_torch.memory.dse.CostCorrection` from the
        stored samples (identity correction when the store is cold)."""
        import math

        from ..memory.dse import CostCorrection  # lazy: no import cycle

        ratios: List[float] = []
        by_term: Dict[str, List[float]] = {}
        for s in self.samples(target_name, signature):
            r = s["measured_s"] / s["predicted_s"]
            ratios.append(r)
            by_term.setdefault(str(s.get("bottleneck", "")), []).append(r)
        if not ratios:
            return CostCorrection()

        def geo(rs: Optional[List[float]]) -> Optional[float]:
            if not rs:
                return None
            return math.exp(sum(math.log(r) for r in rs) / len(rs))

        return CostCorrection(
            factor=geo(ratios) or 1.0, n_samples=len(ratios),
            host_factor=geo(by_term.get("host-link")),
            hbm_factor=geo(by_term.get("hbm")),
            compute_factor=geo(by_term.get("compute")),
        )

    def __len__(self) -> int:
        return sum(len(v) for v in self.data["entries"].values())
