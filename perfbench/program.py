"""The program under test as the cells build it: the port's configuration
of a cell's experiment, held to the sizes of its configuration file, and the
port's detector with the benchmark's weights."""

from __future__ import annotations


def program_config(cell):
    """The port's configuration of the cell's experiment, held to the sizes
    of the cell's configuration file."""
    from sast_tpu_torch.config import get_config

    exp = cell.config["experiment"]
    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in exp.get("overrides", {}).items()}
    cfg = get_config(exp["dataset"], exp["size"], **overrides)
    bb, m = cfg.model.backbone, cfg.model
    seen = dict(
        sensor_hw=list(cfg.dataset.resolution_hw), model_hw=list(bb.in_res_hw),
        input_channels=bb.input_channels, embed_dim=bb.embed_dim,
        dim_multiplier=list(bb.dim_multiplier), num_blocks=list(bb.num_blocks),
        dim_head=bb.attention.dim_head, mlp_ratio=bb.attention.mlp_ratio,
        partition_size=list(bb.attention.partition_size), num_classes=m.head.num_classes,
        fpn_depth=m.fpn.depth, confidence_threshold=m.postprocess.confidence_threshold,
        nms_threshold=m.postprocess.nms_threshold, pre_nms_topk=m.postprocess.pre_nms_topk,
        max_detections=m.postprocess.max_detections, compute_dtype=m.compute_dtype,
        batch_size_train=cfg.training.batch_size_train,
        sequence_length=cfg.dataset.sequence_length,
        max_labeled_frames_per_lane=cfg.training.max_labeled_frames_per_lane,
        max_gt=m.head.max_gt)
    t = cfg.training
    seen.update(
        learning_rate=t.learning_rate, lr_total_steps=t.lr_scheduler.total_steps,
        lr_pct_start=t.lr_scheduler.pct_start, lr_div_factor=t.lr_scheduler.div_factor,
        lr_final_div_factor=t.lr_scheduler.final_div_factor,
        gradient_clip_val=t.gradient_clip_val, weight_decay=t.weight_decay,
        ema_decay=t.ema_decay, remat_policy=t.remat_policy, precision=t.precision)
    if not t.lr_scheduler.use:
        raise ValueError("the reference trains under the one-cycle schedule")
    wrong = {k: (v, cell.config[k]) for k, v in seen.items() if cell.config[k] != v}
    if wrong:
        raise ValueError(f"the port's {exp} differs from {cell.entry['config']}: {wrong}")
    return cfg


def program_model(cfg, weights, device):
    """The port's detector with the benchmark's weights."""
    from sast_tpu_torch.models.detector import YoloXDetector

    model = YoloXDetector(cfg.model).to(device)
    model.load_state_dict(weights, strict=True)
    return model.eval()
