"""Parameter and FLOP counts of a config's network: counterpart of
``tools/analysis_tools/get_flops.py``.

    python -m tpudet_torch.tools.get_flops CONFIG [--shape H [W]]

The model is built on the meta device: no memory, no weights, no kernel.
The parameter count is tpudet's (the leaves of its ``params`` tree), to
the unit. The FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s
count of the forward on one ``(1, H, W, 3)`` image: convolutions and
matrix products only, two operations a multiply-add. tpudet prints XLA's
cost analysis of its compiled program, which also counts the elementwise
ops, the decode and the NMS, so the two numbers are not the same
quantity. A two-stage detector's RoI head is counted on the
``test_cfg.rpn`` number of proposals (its FLOPs do not depend on their
values), as mmdet's ``forward_dummy`` counts it.
"""
import argparse


def count(model, h: int, w: int):
    """``(params, {op name: FLOPs})`` of ``model`` (on the meta device) on
    one ``h x w`` image."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tpudet_torch.models.detectors.two_stage import proposal_kwargs

    n_params = sum(p.numel() for p in model.parameters())
    img = torch.zeros(1, h, w, 3, device='meta')
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        if hasattr(model, 'roi_head'):
            # the proposals' count, not their values, sets the RoI head's
            # FLOPs; the NMS that picks them reads values
            feats = model.extract_feat(img)
            if hasattr(model, 'rpn_head'):
                model.rpn_head(feats)
            cfg = dict(model.test_cfg or {}).get('rpn', {})
            n = proposal_kwargs(cfg, 1000)['max_num']
            model.roi_head(feats, torch.zeros(1, n, 4, device='meta'),
                           torch.ones(1, n, dtype=torch.bool,
                                      device='meta'))
        else:
            model(img)
    flops = {str(op): int(v)
             for op, v in counter.get_flop_counts()['Global'].items()}
    return n_params, flops


def main(argv=None):
    """Print the counts; returns ``(params, total FLOPs)``."""
    p = argparse.ArgumentParser(description='Params and FLOPs of a config')
    p.add_argument('config')
    p.add_argument('--shape', type=int, nargs='+', default=[640, 640])
    args = p.parse_args(argv)

    import torch

    from tpudet_torch.config import Config
    from tpudet_torch.models.builder import build_detector

    cfg = Config.fromfile(args.config)
    with torch.device('meta'):
        model = build_detector(cfg['model']).eval()
    h, w = (args.shape * 2)[:2]
    n_params, flops = count(model, h, w)
    total = sum(flops.values())
    print(f'Input shape: (1, {h}, {w}, 3)')
    print(f'Params: {n_params / 1e6:.2f} M ({n_params})')
    print(f'FLOPs (FlopCounterMode, convolutions and matmuls only): '
          f'{total / 1e9:.2f} GFLOPs '
          f'({", ".join(f"{k} {v / 1e9:.2f}" for k, v in flops.items())})')
    return n_params, total


if __name__ == '__main__':
    main()
