from .batch_eval import POSSIBLE_COUNTS, evaluate_batch
from .countbench import (CountBenchEvaluator, extract_number,
                         generate_templates, load_countbench)
from .crop_detection import (CropDetectionEvaluator, CocoObjectSource,
                             ProceduralObjectSource, crop_to_target_ratio,
                             white_square_image)
from .scoring import TemplateScorer, pad_templates, thresholded_decision
from .vlmsblind import (TASKS, VLMsBlindEvaluator, load_vlmsblind,
                        negative_templates, positive_templates,
                        validate_groundtruth)

__all__ = [
    "POSSIBLE_COUNTS", "evaluate_batch", "CountBenchEvaluator",
    "extract_number", "generate_templates", "load_countbench",
    "CropDetectionEvaluator", "CocoObjectSource", "ProceduralObjectSource",
    "crop_to_target_ratio", "white_square_image", "TemplateScorer",
    "pad_templates", "thresholded_decision", "TASKS", "VLMsBlindEvaluator",
    "load_vlmsblind", "negative_templates", "positive_templates",
    "validate_groundtruth",
]
