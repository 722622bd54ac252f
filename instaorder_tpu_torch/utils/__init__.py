from .geometry import (
    combine_bbox,
    mask_to_bbox,
    bbox_iou,
    crop_padding,
    place_eraser,
    place_eraser_in_ratio,
    scissor_mask,
    scissor_mask_force,
    mask_aug,
    base_aug,
    EraserSetter,
    get_closest_int_multiple_of,
)
