from pulse_tpu_torch.eval.im_eval import EvalResult, im_eval
from pulse_tpu_torch.eval.task_eval import TaskEvalResult, task_eval

__all__ = ["EvalResult", "TaskEvalResult", "im_eval", "task_eval"]
