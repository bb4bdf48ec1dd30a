"""Rolling blue/green upgrades: re-resolve a tag, drain, swap.

The serving analog of the paper's mutable-tag workflow (§3.4: ``stable`` /
``2016.1.0r1`` pointers over immutable digests): a fleet runs whatever
digest its tag resolved to at bring-up; releasing means re-pointing the tag
and rolling the fleet. Per replica, the deployer

  1. builds the GREEN engine from the newly-resolved image first -- its
     compile goes through the shared CompileCache, so identical lowered
     steps (same shapes/mesh) warm-start and the replica is ready to serve
     the moment it is swapped in (the import-problem fix applied to
     rollover);
  2. marks the BLUE engine draining: no new admissions, in-flight requests
     decode to completion while the rest of the pod keeps serving;
  3. swaps GREEN into the pod and retires BLUE.

Capacity never drops below N-1 replicas and in-flight requests are never
killed -- the invariants the orchestrator tests pin down.

The same deployer scales to a **fleet**: construct it with a ``PodRouter``
instead of a (pod, scheduler) pair and ``upgrade()`` rolls pod-by-pod.
The rolling pod is drained *at the router* (new traffic routes around it;
its queued + in-flight work finishes on its own scheduler), every drain
tick goes through ``router.step`` so the non-rolling pods keep admitting
and decoding throughout, and fleet capacity never drops below N-1 pods
(the report records the observed floor).

PyTorch port of ``repro.orchestrator.deployer``, line for line.
"""

from __future__ import annotations

from repro_torch.orchestrator.pod import Pod
from repro_torch.orchestrator.router import PodRouter
from repro_torch.orchestrator.scheduler import ContinuousScheduler


class RollingDeployer:
    def __init__(self, target: Pod | PodRouter,
                 scheduler: ContinuousScheduler | None = None):
        if isinstance(target, PodRouter):
            self.router: PodRouter | None = target
            self.pod, self.scheduler = None, None
        else:
            if scheduler is None:
                raise ValueError("pod-scoped deploys need the pod's scheduler")
            self.router = None
            self.pod, self.scheduler = target, scheduler

    def upgrade(self, ref: str | None = None) -> dict:
        """Roll onto whatever ``ref`` (default: the pod's/fleet's own tag)
        resolves to now. No-op if the digest is unchanged."""
        if self.router is not None:
            return self._upgrade_fleet(ref)
        return self._upgrade_pod(self.pod, self.scheduler, ref)

    # -- one pod (the original scope) ---------------------------------------
    def _upgrade_pod(self, pod: Pod, scheduler: ContinuousScheduler,
                     ref: str | None, tick_fn=None) -> dict:
        ref = ref or pod.ref
        if ref is None:
            raise ValueError("pod was built from a raw image; pass a ref")
        new_digest = pod.runtime.registry.resolve(ref)
        old_digest = pod.image.digest
        report = {"ref": ref, "from": old_digest[:12], "to": new_digest[:12],
                  "changed": new_digest != old_digest, "replicas": []}
        if not report["changed"]:
            return report

        new_image = pod.runtime.pull(ref)
        for i in range(len(pod.engines)):
            blue = pod.engines[i]
            green = pod.make_engine(new_image, i)   # compile before drain
            in_flight = len(blue.active)
            drain_ticks = scheduler.drain(blue, tick_fn=tick_fn)
            blue.release()          # free the blue generation's device state
            pod.engines[i] = green
            pod.retired.append(blue)
            report["replicas"].append({
                "replica": i,
                "in_flight_at_drain": in_flight,
                "drain_ticks": drain_ticks,
                "container_old": blue.container.container_id,
                "container_new": green.container.container_id,
            })
        pod.image = new_image
        pod.ref = ref
        pod.drop_params(old_digest)   # last blue gone; free its params
        pod.write_state()
        return report

    # -- the whole fleet ----------------------------------------------------
    def _upgrade_fleet(self, ref: str | None) -> dict:
        router = self.router
        refs = {p.ref for p in router.pods}
        ref = ref or (refs.pop() if len(refs) == 1 and None not in refs
                      else None)
        if ref is None:
            raise ValueError(
                "fleet pods carry no common tag; pass a ref explicitly")

        report = {"ref": ref, "router": router.router_id, "pods": [],
                  "changed": False,
                  # observed fleet-capacity floor across every drain tick:
                  # the N-1 invariant, measured rather than asserted
                  "capacity_floor": None}

        def note_capacity():
            report["capacity_floor"] = (
                router.capacity if report["capacity_floor"] is None
                else min(report["capacity_floor"], router.capacity))

        def tick():
            note_capacity()
            router.step()

        for pod in router.pods:
            router.drain_pod(pod)       # new traffic routes around this pod
            note_capacity()     # even an instant drain records the floor
            try:
                rec = self._upgrade_pod(pod, router.scheduler_for(pod), ref,
                                        tick_fn=tick)
            finally:
                router.undrain_pod(pod)
            report["pods"].append(rec)
            report["changed"] = report["changed"] or rec["changed"]
        router.write_state()
        return report
