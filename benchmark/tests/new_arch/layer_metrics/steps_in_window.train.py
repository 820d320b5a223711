"""Train steps the measured window ran."""


def read(m):
    return m.window["attempted"]
