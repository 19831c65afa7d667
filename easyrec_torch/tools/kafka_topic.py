"""Read or write a Kafka topic with the port's wire-protocol client.

Counterpart of easyrec_tpu/tools/kafka_topic.py over
easyrec_torch/data/kafka_client.py (standard library only): it feeds
KafkaInput topics one CSV line a message, and reads them back.

  # publish each line of a file as one message
  python -m easyrec_torch.tools.kafka_topic write \
      --servers localhost:9092 --topic t --input_path train.csv \
      [--partition 0] [--skip_header]

  # print messages (partition, offset, value) from the earliest offset
  python -m easyrec_torch.tools.kafka_topic read \
      --servers localhost:9092 --topic t [--max_messages 100]
"""

from __future__ import annotations

import argparse
import sys

from easyrec_torch.data.kafka_client import (EARLIEST, LATEST, KafkaConsumer,
                                             KafkaProducer)


def write_topic(servers: str, topic: str, lines, partition: int = 0,
                skip_header: bool = False) -> int:
  """Publish each non-empty line as one message; returns the count."""
  producer = KafkaProducer(servers)
  n = 0
  try:
    for i, line in enumerate(lines):
      if skip_header and i == 0:
        continue
      line = line.rstrip('\n')
      if not line:
        continue
      producer.send(topic, line.encode('utf-8'), partition=partition)
      n += 1
  finally:
    producer.close()
  return n


def read_topic(servers: str, topic: str, max_messages: int = 0,
               from_latest: bool = False):
  """Yield (partition, offset, value bytes) up to the high watermarks."""
  consumer = KafkaConsumer(servers)
  try:
    parts = consumer.partitions_for(topic)
    start = consumer.offsets(topic, parts,
                             LATEST if from_latest else EARLIEST)
    ends = consumer.offsets(topic, parts, LATEST)
    cur = dict(start)
    n = 0
    while any(cur[p] < ends[p] for p in parts):
      records, hwm = consumer.fetch(topic, cur)
      if not records:
        break
      for pid, off, _key, value in records:
        yield pid, off, value
        cur[pid] = max(cur[pid], off + 1)
        n += 1
        if max_messages and n >= max_messages:
          return
      ends = {p: max(ends[p], hwm.get(p, ends[p])) for p in parts}
  finally:
    consumer.close()


def main(argv=None):
  parser = argparse.ArgumentParser()
  sub = parser.add_subparsers(dest='cmd', required=True)
  w = sub.add_parser('write')
  w.add_argument('--servers', required=True)
  w.add_argument('--topic', required=True)
  w.add_argument('--input_path', required=True)
  w.add_argument('--partition', type=int, default=0)
  w.add_argument('--skip_header', action='store_true')
  r = sub.add_parser('read')
  r.add_argument('--servers', required=True)
  r.add_argument('--topic', required=True)
  r.add_argument('--max_messages', type=int, default=0)
  r.add_argument('--from_latest', action='store_true')
  args = parser.parse_args(argv)
  if args.cmd == 'write':
    with open(args.input_path) as f:
      n = write_topic(args.servers, args.topic, f, partition=args.partition,
                      skip_header=args.skip_header)
    print('wrote %d messages to %s' % (n, args.topic), file=sys.stderr)
  else:
    for pid, off, value in read_topic(args.servers, args.topic,
                                      args.max_messages, args.from_latest):
      print('%d\t%d\t%s' % (pid, off, value.decode('utf-8', 'replace')))


if __name__ == '__main__':
  main()
