"""Worker process for the REAL multi-process distributed test.

Launched N times by tests/test_distributed.py (and usable standalone) with a
local jax.distributed coordinator — no monkeypatching anywhere: every
process joins the job through ``distributed.maybe_initialize`` and runs the
production ``compress_to_file`` / ``decompress_to_file`` cooperatively. The
reference analog is the host driver's DPU-rank fan-out
(snappy_compress.c:553-618); here each rank is an OS process owning a
contiguous block range.

Usage:
    python multiproc_worker.py <pid> <nproc> <port> <src> <out> <dec> \
        <block_size> <engine> [num_threads]

Prints one JSON line with per-process phase timings and peak RSS.
"""

import json
import pathlib
import resource
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    src, out, dec = sys.argv[4], sys.argv[5], sys.argv[6]
    block_size, engine = int(sys.argv[7]), sys.argv[8]
    num_threads = int(sys.argv[9]) if len(sys.argv) > 9 else 0

    import os

    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    os.environ.update(
        PIM_NUM_PROCESSES=str(nproc),
        PIM_PROCESS_ID=str(pid),
        PIM_COORDINATOR=f"localhost:{port}",
    )
    from pim_compression_tpu.parallel import distributed

    assert distributed.maybe_initialize()
    assert jax.process_count() == nproc, "distributed init did not take"

    from jax.experimental import multihost_utils

    from pim_compression_tpu.runtime.profiling import PhaseTimer
    from pim_compression_tpu.utils.config import CodecConfig

    config = CodecConfig(
        block_size=block_size, engine=engine, num_threads=num_threads
    )
    import time

    # Process-CPU seconds around each codec run, alongside the wall-clock
    # phases: on an oversubscribed VM (procs ~ cores) wall time per process
    # includes scheduler timesharing with every other process's ambient
    # threads; CPU time measures the work this process actually did. If
    # max-process CPU at N approximates the N=1 kernel time / N, the codec
    # divides its work perfectly and any wall-clock efficiency deficit is
    # machine contention, not coordination overhead.
    ct = PhaseTimer()
    cpu0 = time.process_time()
    cstats = distributed.compress_to_file(src, out, config, ct)
    c_cpu = time.process_time() - cpu0
    # All segments must be on disk before anyone re-reads the stream.
    multihost_utils.sync_global_devices("pim_test_compress_done")
    dt = PhaseTimer()
    cpu0 = time.process_time()
    dstats = distributed.decompress_to_file(out, dec, config, dt)
    d_cpu = time.process_time() - cpu0
    multihost_utils.sync_global_devices("pim_test_decompress_done")

    print(
        json.dumps(
            {
                "pid": pid,
                "nproc": nproc,
                "process_blocks": cstats["process_blocks"],
                "compress_phases_s": ct.seconds,
                "decompress_phases_s": dt.seconds,
                "compress_cpu_s": round(c_cpu, 4),
                "decompress_cpu_s": round(d_cpu, 4),
                "compressed": cstats["compressed"],
                "total": dstats["total"],
                "peak_rss_mb": round(
                    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1
                ),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
