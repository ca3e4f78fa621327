"""The ``--check`` of the example twins (examples/*_torch.py): each twin
gathers the claims its reference's docstring makes into a dict of name →
whether it holds, and hands it here."""


def check_claims(claims: dict, check: bool) -> None:
    """With ``--check``: print how many claims hold, and raise naming those
    that do not."""
    if not check:
        return
    failed = [k for k, ok in claims.items() if not ok]
    print(f"[check] {len(claims) - len(failed)} of {len(claims)} claims hold")
    if failed:
        raise SystemExit("claims failed: " + "; ".join(failed))
