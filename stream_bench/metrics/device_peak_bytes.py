"""device_peak_bytes (bytes): the most device memory the run held allocated
at once, the CUDA caching allocator's peak read after the window
(``torch.cuda.max_memory_allocated``, the result's ``memory_peak_bytes``):
set-up, the warm-up job and the window's jobs. Nothing on a run without a
card."""


def read(run):
    return run.memory_peak_bytes or None
