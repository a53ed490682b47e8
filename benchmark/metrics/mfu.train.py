"""mfu.train: the model's FLOPs of the traced train window over the card's
peak in that window, in %: FLOPs per step (forward, loss and backward),
counted once at set-up by `torch.utils.flop_counter.FlopCounterMode` on
the benchmark's plain reference at the cell's shapes (matrix products and
convolutions), times the window's steps, over (the window's seconds x peak).

Peak: the float32 cells' dense TF32 tensor-core rate, 495 TFLOP/s (NVIDIA
H100 SXM data sheet, at the card's 700 W power limit), since float32-exact
work may run on the tensor cores as three TF32 passes; against the 67
TFLOP/s of float32 outside them such a step could read above 100%.
"""
PEAK_FLOPS = 495e12
FLOPS = True


def read(run):
    if run.kind != "train" or not run.flops or run.steps == 0 or run.timeline is None:
        return None
    return 100.0 * run.flops * run.steps / (run.window_s * PEAK_FLOPS)
