from pulse_tpu_torch.eval.im_eval import EvalResult, im_eval

__all__ = ["EvalResult", "im_eval"]
