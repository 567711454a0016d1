"""Output tokens per second: every token the engine emitted inside the
window (a handed-over first token came from the prefill instance and is
not counted) over the window's host seconds."""


def read(w):
    return w.output_tokens / w.window_s if w.window_s > 0 else None
