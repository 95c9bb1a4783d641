"""Worker process for the two-process SlotServer test.

Run as:  python tests/_slotserver_worker.py <pid> <nprocs> <coord> <out.npz>

Each process owns 2 local CPU devices (stream=1 x freq=2: the freq
psum runs between this process's own devices, as within one host) and
feeds only its own slot rows — exercising exactly the
make_array_from_process_local_data and addressable-shard-readback
branches of parallel/multihost.py that a single-process virtual mesh
cannot reach.
"""

import sys


def make_inputs(row, tick, t, cin, fragm):
    import numpy as np

    rng = np.random.default_rng(1000 + row * 17 + tick)
    return (rng.standard_normal((t, cin, fragm)) * 0.3).astype(np.float32)


def main():
    pid, nprocs, coord, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nprocs, process_id=pid
    )
    import numpy as np

    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 2 * nprocs, len(jax.devices())

    from folve_tpu.engine.filter_bank import compile_filter_bank
    from folve_tpu.parallel.multihost import (
        SlotServer,
        make_multihost_serving_mesh,
    )

    rng = np.random.default_rng(5)
    size = 4096
    ir = (rng.standard_normal((2, 2, size)) / np.sqrt(size)).astype(np.float32)
    bank = compile_filter_bank(ir)
    mesh = make_multihost_serving_mesh(freq_parallel=2)
    assert mesh.shape == {"host": nprocs, "stream": 1, "freq": 2}, mesh.shape

    s_local, t = 2, 2
    srv = SlotServer(mesh, bank, s_local=s_local, t=t)
    assert srv.host_index == pid
    rows = range(pid * s_local, (pid + 1) * s_local)
    outs = {}
    for tick in range(3):
        x_blocks = {
            row: make_inputs(row, tick, t, 2, bank.fragm) for row in rows
        }
        if tick == 2:
            # one idle slot this tick: state must carry through unchanged
            del x_blocks[pid * s_local + 1]
        y = srv.tick(x_blocks)
        assert sorted(y) == sorted(x_blocks)
        for row, blk in y.items():
            outs[f"r{row}_t{tick}"] = blk
    np.savez(out_path, **outs)
    print("WORKER_OK", pid, flush=True)


if __name__ == "__main__":
    main()
