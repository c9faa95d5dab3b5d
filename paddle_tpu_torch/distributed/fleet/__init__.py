"""The fleet utilities the elastic launcher needs (counterpart of
paddle_tpu/distributed/fleet; the rest comes with ROADMAP.md item 13)."""
