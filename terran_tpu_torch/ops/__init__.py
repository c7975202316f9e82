from terran_tpu_torch.ops.nms import nms_fixed, iou_matrix  # noqa
