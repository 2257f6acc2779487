"""The benchmark's own recording around the program's kernel calls in a
traced window: the shapes each K1 sweep and each K2 layer was given, from
which ``counts`` works out their bounds. Recording keeps references only;
the arithmetic runs after the window."""

from __future__ import annotations

from portbench import counts


def activities(device):
    from torch.profiler import ProfilerActivity

    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])


class Recorder:
    """Wraps ``ops.vq.distance_topk`` (each K1 sweep: z rows, codebook
    rows, width, k) and the BERT's ``packed_segment_attention`` (each K2
    layer: its segment ids, heads and head width) while active."""

    def __init__(self):
        self.k1: list[tuple[int, int, int, int]] = []
        self.k2: list[tuple[object, int, int]] = []

    def __enter__(self):
        from medtok_tpu_torch.models import bert
        from medtok_tpu_torch.ops import vq

        self._vq, self._bert = vq, bert
        self._topk, self._seg = vq.distance_topk, bert.packed_segment_attention
        topk, seg = self._topk, self._seg

        def distance_topk(z_n, e_n, k, **kw):
            self.k1.append((z_n.shape[0], e_n.shape[0], z_n.shape[1], k))
            return topk(z_n, e_n, k, **kw)

        def packed_segment_attention(q, k, v, segments, **kw):
            self.k2.append((segments, q.shape[1], q.shape[3]))
            return seg(q, k, v, segments, **kw)

        vq.distance_topk = distance_topk
        bert.packed_segment_attention = packed_segment_attention
        return self

    def __exit__(self, *exc):
        self._vq.distance_topk = self._topk
        self._bert.packed_segment_attention = self._seg
        return False

    def k1_bound_s(self) -> float:
        return sum(counts.k1_bound_s(*s) for s in self.k1)

    def k2_bound_s(self) -> float:
        bound = {}      # the layers of one BERT step share its segment ids
        for seg, h, dh in self.k2:
            key = (id(seg), h, dh)
            if key not in bound:
                bound[key] = counts.k2_bound_s(seg.cpu().numpy(), h, dh)
        return sum(bound[(id(seg), h, dh)] for seg, h, dh in self.k2)
