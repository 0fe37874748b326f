"""Real-apiserver adapter: the in-memory KubeClient surface
(kube/client.py) implemented over the Kubernetes REST API with stdlib
HTTP only. The API is plain HTTPS+JSON (ref seam: operator.go:105-171,
where the reference builds its client-go clients; envtest
environment.go:80).

The port's copy of ``karpenter_core_tpu/kube/restclient.py``. The
reference's two watch-backoff knobs are module constants named for
their twin, which tests monkeypatch: ``WATCH_BACKOFF_BASE_MS``
(``KARPENTER_TPU_WATCH_BACKOFF_BASE_MS``) and ``WATCH_BACKOFF_MAX_MS``
(``KARPENTER_TPU_WATCH_BACKOFF_MAX_MS``).

Usage:
    kube = RestKubeClient("https://127.0.0.1:6443", token=...)

Semantics mirrored from the in-memory store:
- get/list/create/update/apply/delete/remove_finalizer/retry_on_conflict
- update() surfaces HTTP 409 as Conflict (optimistic concurrency is the
  apiserver's own resourceVersion check)
- watch(kind, cb) lists (synthetic ADDED replay, informer semantics),
  then streams ?watch=1 chunks on a daemon thread, resuming from the
  last resourceVersion; callbacks receive decoded dataclasses
- delete() is finalizer-aware by the apiserver itself (it stamps
  deletionTimestamp while finalizers remain)

The in-memory store remains the test/simulation control plane; this
adapter is for running against a live cluster (kind, or any conformant
apiserver).
"""

from __future__ import annotations

import json
import random
import ssl
import threading
import urllib.error
import urllib.request
from typing import Callable, List, Optional

from .client import ADDED, DELETED, MODIFIED, Conflict, NotFound
from .codec import API_PATHS, OBJECT_TYPES, from_k8s, to_k8s
from .objects import KubeObject, LabelSelector


class ApiError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


# the watch loop's backoff ladder: its first step and its cap, in ms
WATCH_BACKOFF_BASE_MS = 200.0
WATCH_BACKOFF_MAX_MS = 5000.0


class WatchBackoff:
    """Capped exponential backoff with full jitter for the relist and
    watch-error retry paths: retries are never a hot loop (delay is
    bounded below by base/2) and never unbounded (capped at
    ``WATCH_BACKOFF_MAX_MS``). A healthy stream resets
    the ladder, so a one-off flap pays one base delay, not the cap."""

    def __init__(
        self,
        base_ms: Optional[float] = None,
        max_ms: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ):
        if base_ms is None:
            base_ms = WATCH_BACKOFF_BASE_MS
        if max_ms is None:
            max_ms = WATCH_BACKOFF_MAX_MS
        self.base_s = max(0.001, base_ms) / 1000.0
        self.max_s = max(self.base_s, max_ms / 1000.0)
        self._rng = rng or random.Random()
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def next_delay(self) -> float:
        cap = min(self.max_s, self.base_s * (2.0 ** self._attempt))
        self._attempt += 1
        return cap * (0.5 + 0.5 * self._rng.random())

    def reset(self) -> None:
        self._attempt = 0


class RestKubeClient:
    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure_skip_verify: bool = False,
        timeout: float = 30.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        if base_url.startswith("https"):
            if insecure_skip_verify:
                ctx = ssl._create_unverified_context()
            else:
                ctx = ssl.create_default_context(cafile=ca_file)
            self._ctx: Optional[ssl.SSLContext] = ctx
        else:
            self._ctx = None
        self._watch_threads: List[threading.Thread] = []
        self._streams: List = []
        self._stopping = threading.Event()
        # admission parity with the in-memory client: a real apiserver
        # runs its own webhooks, so this chain is typically empty
        self.admission: List[Callable[[KubeObject], None]] = []
        # chaos seam: an optional callable consulted before
        # every HTTP request — fault_injector(method, path, stream) may
        # sleep (latency spike) or raise (410 storm, connection reset).
        # kube/faults.py:RestFaultInjector is the seeded implementation.
        self.fault_injector: Optional[Callable[[str, str, bool], None]] = None
        # watch-loop observability, attached via attach_watch_metrics
        # (kube/ stays metrics-agnostic; the operator wiring owns the
        # registry): relists / errors / backoff-seconds counters
        self._watch_metrics: dict = {}

    def attach_watch_metrics(
        self, relists=None, errors=None, backoff_seconds=None
    ) -> None:
        """Attach the karpenter_tpu_watch_{relists,errors,
        backoff_seconds}_total counters (metrics/registry.py Metrics.
        watch_*). Safe to call any time; watch threads pick the sinks
        up on their next use."""
        self._watch_metrics = {
            "relists": relists,
            "errors": errors,
            "backoff_seconds": backoff_seconds,
        }

    def _watch_count(self, name: str, value: float = 1.0, **labels) -> None:
        sink = self._watch_metrics.get(name)
        if sink is not None:
            sink.inc(value, **labels)

    # -- plumbing ----------------------------------------------------------

    def _path(self, kind: str, namespace: str = "", name: str = "") -> str:
        prefix, plural, namespaced = API_PATHS[kind]
        path = prefix
        if namespaced and namespace:
            path += f"/namespaces/{namespace}"
        path += f"/{plural}"
        if name:
            path += f"/{name}"
        return path

    def _request(self, method: str, path: str, body: Optional[dict] = None, stream: bool = False):
        req = urllib.request.Request(
            self.base_url + path,
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
        )
        req.add_header("Accept", "application/json")
        if body is not None:
            req.add_header(
                "Content-Type",
                "application/merge-patch+json" if method == "PATCH" else "application/json",
            )
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        inject = self.fault_injector
        if inject is not None:
            inject(method, path, stream)
        try:
            resp = urllib.request.urlopen(
                req, timeout=None if stream else self.timeout, context=self._ctx
            )
        except urllib.error.HTTPError as err:
            detail = err.read().decode("utf-8", "replace")[:400]
            if err.code == 409:
                raise Conflict(detail) from None
            if err.code == 404:
                raise NotFound(detail) from None
            raise ApiError(err.code, f"apiserver {method} {path}: {detail}") from None
        if stream:
            return resp
        with resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    # -- CRUD --------------------------------------------------------------

    def get(self, kind: str, name: str, namespace: str = "") -> Optional[KubeObject]:
        try:
            return from_k8s(kind, self._request("GET", self._path(kind, namespace, name)))
        except NotFound:
            return None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
        filter_fn: Optional[Callable[[KubeObject], bool]] = None,
    ) -> List[KubeObject]:
        data = self._request("GET", self._path(kind, namespace or ""))
        objs = [from_k8s(kind, item) for item in data.get("items", [])]
        if namespace is not None:
            objs = [o for o in objs if o.namespace == namespace]
        if label_selector is not None:
            objs = [o for o in objs if label_selector.matches(o.metadata.labels)]
        if filter_fn is not None:
            objs = [o for o in objs if filter_fn(o)]
        return objs

    def create(self, obj: KubeObject) -> KubeObject:
        for adm in self.admission:
            adm(obj)
        body = to_k8s(obj)
        body["metadata"].pop("resourceVersion", None)
        data = self._request("POST", self._path(obj.kind, obj.namespace), body)
        return from_k8s(obj.kind, data)

    def update(self, obj: KubeObject) -> KubeObject:
        """JSON merge-patch, not PUT: the codec encodes only the fields
        the controllers own, and a PUT would clear every server-owned
        field it omits (node podCIDR etc.). The patch body carries
        metadata.resourceVersion, so the apiserver still enforces
        optimistic concurrency (409 → Conflict). Status goes to the
        /status subresource when the kind serves one (CRDs with the
        subresource strip status from main-resource writes)."""
        for adm in self.admission:
            adm(obj)
        body = to_k8s(obj)
        status = body.pop("status", None)
        path = self._path(obj.kind, obj.namespace, obj.name)
        data = self._request("PATCH", path, body)
        if status:
            # the main patch bumped resourceVersion, so the status write
            # must be unconditional (carrying the stale rv would 409)
            status_patch = {"status": status}
            try:
                data = self._request("PATCH", path + "/status", status_patch)
            except (NotFound, ApiError):
                # no status subresource: status rides a main-resource patch
                data = self._request("PATCH", path, status_patch)
        decoded = from_k8s(obj.kind, data)
        obj.metadata.resource_version = decoded.metadata.resource_version
        return decoded

    def apply(self, obj: KubeObject) -> KubeObject:
        if self.get(obj.kind, obj.name, namespace=obj.namespace) is None:
            return self.create(obj)
        return self.update(obj)

    def delete(self, obj_or_kind, name: str = "", namespace: str = "") -> bool:
        if isinstance(obj_or_kind, KubeObject):
            kind, name, namespace = obj_or_kind.kind, obj_or_kind.name, obj_or_kind.namespace
        else:
            kind = obj_or_kind
        try:
            self._request("DELETE", self._path(kind, namespace, name))
        except NotFound:
            return False
        return True

    def remove_finalizer(self, obj: KubeObject, finalizer: str) -> None:
        def mutate(o: KubeObject) -> None:
            if finalizer in o.metadata.finalizers:
                o.metadata.finalizers.remove(finalizer)

        self.retry_on_conflict(obj.kind, obj.name, namespace=obj.namespace, mutate=mutate)

    def retry_on_conflict(
        self,
        kind: str,
        name: str,
        namespace: str = "",
        mutate: Callable[[KubeObject], None] = lambda obj: None,
        attempts: int = 5,
    ) -> KubeObject:
        last: Optional[Conflict] = None
        for _ in range(attempts):
            obj = self.get(kind, name, namespace=namespace)
            if obj is None:
                raise NotFound(f"{kind} ({namespace!r}, {name!r}) not found")
            mutate(obj)
            try:
                return self.update(obj)
            except Conflict as err:
                last = err
        raise last if last is not None else Conflict(f"{kind} {name}: retries exhausted")

    # -- watches -----------------------------------------------------------

    def watch(self, kind: str, callback: Callable[[str, KubeObject], None]) -> Callable[[], None]:
        """List + watch with synthetic ADDED replay, like the in-memory
        store (informer semantics). The stream runs on a daemon thread,
        resumes from the last seen resourceVersion, and on an expired
        version (HTTP 410 / in-stream ERROR) RE-LISTS and diffs against
        the known set — emitting DELETED for objects that vanished in
        the gap — before re-watching. Callback exceptions are isolated
        (logged, event skipped) so one bad object can't kill the stream."""
        import logging

        log = logging.getLogger("karpenter.torch.restclient")
        known: dict = {}  # (namespace, name) -> True

        def deliver(etype: str, obj: KubeObject) -> None:
            key = (obj.namespace, obj.name)
            if etype == DELETED:
                known.pop(key, None)
            else:
                known[key] = True
            try:
                callback(etype, obj)
            except Exception:  # noqa: BLE001 — a bad object must not kill the watch
                log.exception("watch callback failed for %s %s", kind, key)

        def relist(first: bool) -> str:
            data = self._request("GET", self._path(kind))
            self._watch_count("relists", kind=kind)
            rv = (data.get("metadata") or {}).get("resourceVersion", "0")
            seen = set()
            for item in data.get("items", []):
                obj = from_k8s(kind, item)
                seen.add((obj.namespace, obj.name))
                deliver(ADDED if first or (obj.namespace, obj.name) not in known else MODIFIED, obj)
            for key in [k for k in known if k not in seen]:
                ghost = OBJECT_TYPES[kind]()
                ghost.metadata.namespace, ghost.metadata.name = key
                deliver(DELETED, ghost)
            return rv

        rv = relist(first=True)
        unsubscribed = threading.Event()
        live = {"resp": None}  # the stream unsubscribe must unblock
        backoff = WatchBackoff()

        def back_off() -> bool:
            """Sleep one capped+jittered backoff step; True → exit the
            watch thread (unsubscribed/stopping fired mid-sleep)."""
            delay = backoff.next_delay()
            self._watch_count("backoff_seconds", delay, kind=kind)
            return unsubscribed.wait(delay) or self._stopping.is_set()

        def stream():
            last_rv = rv
            while not (self._stopping.is_set() or unsubscribed.is_set()):
                try:
                    resp = self._request(
                        "GET",
                        self._path(kind)
                        + f"?watch=1&resourceVersion={last_rv}&allowWatchBookmarks=true",
                        stream=True,
                    )
                    live["resp"] = resp
                    self._streams.append(resp)
                    try:
                        for line in resp:
                            if self._stopping.is_set() or unsubscribed.is_set():
                                return
                            if not line.strip():
                                continue
                            event = json.loads(line)
                            etype = event.get("type", "")
                            item = event.get("object") or {}
                            new_rv = (item.get("metadata") or {}).get("resourceVersion")
                            if new_rv:
                                last_rv = new_rv
                            if etype == "BOOKMARK":
                                continue
                            if etype == "ERROR":
                                self._watch_count("errors", kind=kind, reason="error_event")
                                last_rv = relist(first=False)  # expired rv
                                break
                            mapped = {
                                "ADDED": ADDED,
                                "MODIFIED": MODIFIED,
                                "DELETED": DELETED,
                            }.get(etype)
                            if mapped:
                                deliver(mapped, from_k8s(kind, item))
                                backoff.reset()  # healthy stream: next error starts at base
                    finally:
                        try:
                            self._streams.remove(resp)
                            resp.close()
                        except (ValueError, OSError):
                            pass
                except ApiError as err:
                    self._watch_count(
                        "errors", kind=kind, reason="410" if err.code == 410 else "http"
                    )
                    if err.code == 410:  # Gone: event cache window passed
                        try:
                            last_rv = relist(first=False)
                        except Exception:
                            pass
                    if back_off():
                        return
                except Exception:
                    # stream dropped (network, apiserver restart): back
                    # off (capped exponential + jitter) and resume from
                    # the last seen rv
                    self._watch_count("errors", kind=kind, reason="stream")
                    if back_off():
                        return

        thread = threading.Thread(target=stream, name=f"watch-{kind}", daemon=True)
        thread.start()
        self._watch_threads.append(thread)

        def unsubscribe():
            unsubscribed.set()
            resp = live.get("resp")
            if resp is not None:
                try:
                    resp.close()  # unblock a quiet stream read immediately
                except OSError:
                    pass

        return unsubscribe

    def close(self) -> None:
        self._stopping.set()
        # unblock streams stuck in a read so their threads can exit
        for resp in list(self._streams):
            try:
                resp.close()
            except OSError:
                pass
        for thread in self._watch_threads:
            thread.join(timeout=2.0)
        self._watch_threads = []
