"""Examples a second: every example of the window's steps over the
window's time, from a synchronize after the warm-up to the synchronize
after the last step."""


def read(run):
  w = run.window
  return w['steps'] * run.cell.batch_size / w['seconds']
