"""The share of the TDT loop's row slots that did work, in percent: the
program's ``asr.tdt_row_iterations`` counter (live rows summed over the
iterations, counted on the card) over ``asr.tdt_iterations`` (iterations
run, a program's worth a launch) times the batch's rows, both counted in
the traced window. Rows that finished early, silent rows and the
iterations after a batch's last row are the idle slots. None where the
program has no such counter."""


def read(record):
    try:
        from svecalign_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.traced_counts()
    iterations = counts.get("asr.tdt_iterations", 0)
    if not iterations:
        return None
    rows = int(record.cell["asr_options"]["batch"])
    return 100.0 * counts.get("asr.tdt_row_iterations", 0) / (iterations * rows)
