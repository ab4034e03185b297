"""``recaptures.rollout``: captures of the rollout step the port made per
request of the window (new ``CapturedStep``s among ``captured_step.steps_of``
the model, counted by the serving runner after each request). A request
whose padded shapes the port holds no capture of pays a warm-up step and a
capture on the host while the card waits."""


def read(runner, breakdown):
    caps = runner.captures
    return sum(caps) / len(caps) if caps else None
