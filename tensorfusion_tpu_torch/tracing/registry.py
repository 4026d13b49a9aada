"""Registry of every span name tpu-fusion records: the port's copy of
``tensorfusion_tpu/tracing/registry.py``, so a trace the port assembles
(a remote GENERATE's client and server spans) is checked against the
same catalog by ``tracing/export.py:validate``.

Attribute conventions: ``attrs`` lists the keys a site may stamp;
``error`` is implicitly allowed on every span.
"""

SPAN_SCHEMA = {
    # -- remote-vTPU serving path (client -> wire -> dispatcher -> device)
    "client.remote_jit": {
        "attrs": ("fn", "busy_retries", "reconnects"),
    },
    "client.serialize": {
        "attrs": ("exe_id", "cached"),
    },
    "client.wire": {
        "attrs": ("exe_id", "deadline_ms", "n_results", "microbatched",
                  "enc", "wire_bytes", "overlap_depth"),
    },
    "dispatcher.queue": {
        "attrs": ("qos", "tenant", "wait_ms"),
    },
    "device.launch": {
        "attrs": ("exe_id", "batch", "mflops"),
    },
    "worker.upload": {
        "attrs": ("exe_id", "args", "enc", "wire_bytes",
                  "overlap_depth"),
    },
    "worker.flush": {
        "attrs": ("exe_id", "results"),
    },
    # -- federated multi-worker meshes (remoting/federation.py,
    # docs/federation.md): one cross-worker collective (flat or ring)
    # and one per-worker shard launch of a federated call/step
    "fed.collective": {
        "attrs": ("op", "workers", "ring", "fabric", "raw_bytes",
                  "wire_bytes", "hidden_ms"),
    },
    "fed.shard_exec": {
        "attrs": ("worker", "fn", "mode"),
    },
    # -- peer fabric (protocol v9, docs/federation.md "peer fabric"):
    # one worker's leg of a zero-relay ring AllReduce — reduce /
    # install hops ride worker-to-worker PeerLinks, the client only
    # sees receipts
    "fabric.ring": {
        "attrs": ("cid", "index", "workers", "hops", "raw_bytes",
                  "wire_bytes"),
    },
    # -- streaming live migration (protocol v8, docs/migration.md):
    # one pre-copy delta round on the source worker (traced
    # SNAPSHOT_DELTA requests only)
    "migrate.delta": {
        "attrs": ("round", "buffers", "raw_bytes", "wire_bytes",
                  "final"),
    },
    # -- serving engine (tpfserve: continuous batching, docs/serving.md)
    "client.generate": {
        "attrs": ("tokens", "ttft_ms", "busy_retries"),
    },
    "serving.admit": {
        "attrs": ("tenant", "qos", "wait_ms", "prompt_tokens"),
    },
    "serving.prefill_chunk": {
        "attrs": ("tenant", "tokens", "pos"),
    },
    "serving.step": {
        "attrs": ("batch", "tokens"),
    },
    "serving.prefix_match": {
        "attrs": ("tenant", "matched_tokens", "prompt_tokens"),
    },
    "serving.kv_ship": {
        "attrs": ("tenant", "blocks", "shared", "bytes"),
    },
    "serving.spec_verify": {
        "attrs": ("batch", "k", "accepted"),
    },
    # -- policy engine (tpfpolicy closed loop, docs/policy.md): one
    # decide/actuate pair per ledger decision, linked to the decision
    # id so `tpfpolicy explain` and the trace agree
    "policy.decide": {
        "attrs": ("rule", "action", "trigger", "value"),
    },
    "policy.actuate": {
        "attrs": ("rule", "action", "decision"),
    },
    # -- control-plane pod lifecycle (admission -> schedule -> bind)
    "webhook.admit": {
        "attrs": ("pod", "pool", "qos", "workload"),
    },
    "scheduler.schedule": {
        "attrs": ("pod", "code", "node"),
    },
    "scheduler.bind": {
        "attrs": ("pod", "node", "attempts"),
    },
    "workload.spawn": {
        "attrs": ("workload", "pod"),
    },
}
