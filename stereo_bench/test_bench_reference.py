"""The yardstick is right: the benchmark's plain reference agrees with the
port on the tiny model (the miniature trunk, 8-channel stages, f32, the
CPU), the same weights and frames, over a few frames of both
configurations, the reference following the port's state as the check
does, and freely from the start."""
import pytest
import torch

from stereo_bench import serve, traffic as gen
from stereo_bench.conftest import tiny_config
from stereo_bench.reference import net as ref_net

FRAMES = 4
# f32 against f32: the same operations, summed in other orders
TOL = 1e-4


def _state(prev):
    """The port's state as the reference's."""
    snap = serve.Snapshot([t.clone() for t in serve._tensors(prev)])
    snap.flags = (prev.has_memory, prev.cost_memory.valid,
                  prev.local_map_valid)
    return snap.reference()


def _close(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


@pytest.mark.parametrize("config", ["kitti2015-multi", "kitti2015"])
def test_reference_follows_the_port(config):
    from temporalstereo_tpu_torch import streaming_step
    from temporalstereo_tpu_torch.serving import initial_prev

    cfg = tiny_config(config)
    cpu = torch.device("cpu")
    h, w, b = cfg["height"], cfg["width"], 2
    weights = serve.make_weights(cfg["options"], 7, cpu)
    port = serve.build_program(cfg, weights, cpu)
    ref = ref_net.Net(cfg["options"])
    ref.load_state_dict(weights)
    ref.eval()
    mix = {"frame_pool": FRAMES, "forward_m": 0.5, "lateral_m": 0.02,
           "yaw_deg": 0.5, "disparity_px": [2, 16]}
    left, right = gen.frame_pool(mix, b, h, w, 7, cpu)
    K, baseline = gen.camera(b, h, w, cpu)
    T = gen.poses(mix, b, 7, cpu)
    prev = initial_prev(port, b, h, w)
    free = ref_net.zero_state(ref, b, h, w, cpu)
    with torch.no_grad():
        for i in range(FRAMES):
            args = (K, baseline, T[i % 2])
            out, new = streaming_step(port, left[i], right[i], prev, *args)
            disp = out["disps"][0]
            followed = _state(prev) if prev is not None else None
            want, want_state = ref_net.step(ref, left[i].float(),
                                            right[i].float(), followed, *args)
            assert _close(disp, want) < TOL, (config, i)
            if new is not None:
                for got_m, want_m in zip(new.memories, want_state.memories):
                    assert _close(got_m, want_m) < TOL
                assert _close(new.prev_disp, want_state.prev_disp) < TOL
                assert _close(new.cost_memory.disp_sample,
                              want_state.mem_sample) < TOL
                if new.local_map.numel():
                    assert _close(new.local_map, want_state.local_map) < TOL
            if i < 2:       # the free stream, while the splat is continuous
                free_disp, free = ref_net.step(ref, left[i].float(),
                                               right[i].float(), free, *args)
                assert _close(disp, free_disp) < TOL
            prev = new


def test_rows_of_a_batch_match_the_batch():
    """The check warps the batch's state at once (the splat's weights take
    a mean over the batch) and runs the network a stream at a time: the
    same as the whole batch in one."""
    cfg = tiny_config()
    cpu = torch.device("cpu")
    h, w, b = cfg["height"], cfg["width"], 3
    ref = ref_net.Net(cfg["options"])
    ref.load_state_dict(serve.make_weights(cfg["options"], 3, cpu))
    ref.eval()
    mix = {"frame_pool": 2, "forward_m": 0.5, "lateral_m": 0.02,
           "yaw_deg": 0.5, "disparity_px": [2, 16]}
    left, right = gen.frame_pool(mix, b, h, w, 3, cpu)
    K, baseline = gen.camera(b, h, w, cpu)
    T = gen.poses(mix, b, 3, cpu)
    with torch.no_grad():
        _, state = ref_net.step(ref, left[0].float(), right[0].float(),
                                ref_net.zero_state(ref, b, h, w, cpu), K,
                                baseline, T[0])
        whole, _ = ref_net.step(ref, left[1].float(), right[1].float(), state,
                                K, baseline, T[1])
        warped = ref_net.update_state(state, K, baseline, T[1], (h, w), True,
                                      cfg["options"]["MODEL.LOCAL_MAP_SIZE"])
        for row in range(b):
            one = slice(row, row + 1)
            part, _ = ref_net.run(ref, left[1, one].float(),
                                  right[1, one].float(),
                                  ref_net.rows(warped, one))
            assert _close(part, whole[one]) < TOL
