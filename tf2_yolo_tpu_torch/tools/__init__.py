"""Tools of the port: measurement scripts that run on the card, and
``fetch_weights`` (the pretrained-weight cache)."""
