"""Model step: of the rows the traced stretch's forwards ran, the share
that carried a real position, in percent.  The useful rows are the
scheduler's counters (``prefill_fed_tokens`` and ``verify_tokens_fed``);
the rows run are the recorded queries of ``partial_prefill_attention``,
which every forward calls once a layer on all its rows (slots x feed
width, padding included), over the number of layers."""


def read(r):
    calls = (r.calls or {}).get("partial_prefill")
    if not calls:
        return None
    ran = sum(qs[0] * qs[1] for qs, _, _, _ in calls) \
        / r.cfg["num_hidden_layers"]
    return 100.0 * r.stretch_useful_rows / ran if ran else None
